"""The parameter server's tables — the port of
``paddle_tpu/distributed/ps/tables.py``, host code kept as it is there.

Reference: paddle/fluid/distributed/ps/table/{memory_dense_table.cc,
memory_sparse_table.cc}. ``DenseTable`` and ``SparseTable`` run on the
native core of ``csrc/ps_table.cc`` (``runtime.native.PS_TABLE``, built
with ``g++`` at first use), with the reference's numpy fallback where the
build fails. The two initialise rows differently (the core draws a
``mt19937_64`` per id, the fallback draws in sequence), so
``native_tables()`` says which one is in use; the text dumps, the CTR
accessor, the disk-spilling table and the admission ``Entry`` configs
are the reference's.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from ...runtime.native import PS_TABLE

SGD, ADAGRAD = 0, 1
_OPT = {"sgd": SGD, "adagrad": ADAGRAD}


def _lib():
    return PS_TABLE.build()


def native_tables() -> bool:
    """Whether the tables run on the native core (built here if it is
    not yet)."""
    return _lib() is not None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class DenseTable:
    """Flat float32 parameter block with server-side optimizer apply."""

    def __init__(self, size: int, optimizer="sgd", lr=0.01, epsilon=1e-6):
        self.size = int(size)
        self.optimizer = _OPT[optimizer]
        self.lr = float(lr)
        self.epsilon = float(epsilon)
        lib = _lib()
        if lib is not None:
            self._h = lib.ps_dense_new(self.size)
            self._lib = lib
        else:  # numpy fallback
            self._h = None
            self._data = np.zeros(self.size, np.float32)
            self._acc = np.zeros(self.size, np.float32)
            self._g2 = np.zeros(self.size, np.float32)
            self._mu = threading.Lock()

    def assign(self, values: np.ndarray):
        v = np.ascontiguousarray(values, np.float32).reshape(-1)
        assert v.size == self.size
        if self._h:
            self._lib.ps_dense_assign(self._h, _f32p(v), self.size)
        else:
            with self._mu:
                self._data[:] = v

    def read_acc(self) -> np.ndarray:
        """Adagrad accumulator state (checkpointing)."""
        if self._h:
            out = np.empty(self.size, np.float32)
            self._lib.ps_dense_read_acc(self._h, _f32p(out), self.size)
            return out
        with self._mu:
            return self._g2.copy()

    def assign_acc(self, values: np.ndarray):
        v = np.ascontiguousarray(values, np.float32).reshape(-1)
        assert v.size == self.size
        if self._h:
            self._lib.ps_dense_assign_acc(self._h, _f32p(v), self.size)
        else:
            with self._mu:
                self._g2[:] = v

    def read(self) -> np.ndarray:
        out = np.empty(self.size, np.float32)
        if self._h:
            self._lib.ps_dense_read(self._h, _f32p(out), self.size)
        else:
            with self._mu:
                out[:] = self._data
        return out

    def push_grad(self, grad: np.ndarray):
        g = np.ascontiguousarray(grad, np.float32).reshape(-1)
        assert g.size == self.size
        if self._h:
            self._lib.ps_dense_push_grad(self._h, _f32p(g), self.size)
        else:
            with self._mu:
                self._acc += g

    def apply(self) -> float:
        """Apply accumulated grads with the table optimizer; returns |g|."""
        if self._h:
            return float(self._lib.ps_dense_apply(
                self._h, self.optimizer, self.lr, self.epsilon))
        with self._mu:
            g = self._acc
            norm = float(np.linalg.norm(g))
            if self.optimizer == ADAGRAD:
                self._g2 += g * g
                self._data -= self.lr * g / (np.sqrt(self._g2) + self.epsilon)
            else:
                self._data -= self.lr * g
            self._acc[:] = 0
        return norm

    # --------------------------------------- reference text-format interop
    def save_text(self, dirname, table_id=0, mode=0, shard=0):
        """Reference dense dump layout (memory_dense_table.cc:321 Save):
        `<dirname>/<table_id>/part-<shard:03d>` with one line per element;
        mode 0 columns are `weight acc` (resume-exact), mode 3 weight only."""
        import os

        if mode not in (0, 3):
            raise ValueError(
                f"save_text mode {mode!r} not supported: 0 or 3")
        table_dir = os.path.join(str(dirname), str(table_id))
        os.makedirs(table_dir, exist_ok=True)
        path = os.path.join(table_dir, f"part-{shard:03d}")
        if mode != 0:
            w, acc = self.read(), None  # single read cannot tear
        else:
            # tear check: a concurrent apply() between read() and read_acc()
            # would pair pre-update weights with post-update accumulators —
            # re-read until the weights are stable around the acc read (the
            # sparse path gets this from its single export_state call)
            import warnings

            w = self.read()
            for attempt in range(5):
                acc = self.read_acc()
                w2 = self.read()
                if np.array_equal(w, w2, equal_nan=True):
                    break
                w = w2  # reuse the confirming read as the next candidate
            else:
                warnings.warn(
                    "DenseTable.save_text: weights kept changing under a "
                    "concurrent trainer; the dump's weight/accumulator pair "
                    "may be torn — pause updates for a resume-exact "
                    "checkpoint", stacklevel=2)
        with open(path, "w") as f:
            for i in range(self.size):
                line = f"{w[i]:.9g}"
                if acc is not None:
                    line += f" {acc[i]:.9g}"
                f.write(line + "\n")
        return path

    def load_text(self, dirname, table_id=0):
        """Inverse of save_text; weight-only lines reset the accumulator."""
        import glob
        import os

        parts = sorted(glob.glob(
            os.path.join(str(dirname), str(table_id), "part-*")))
        if not parts:
            raise FileNotFoundError(
                f"no part-* files under {dirname}/{table_id}")
        w, acc = [], []
        for p in parts:
            with open(p) as f:
                for line in f:
                    toks = line.split()
                    if not toks:
                        continue
                    if len(toks) > 2:
                        # e.g. an adam_d2sum reference dump (weight avg_w
                        # acc ...): guessing which column is the adagrad
                        # accumulator would silently corrupt resume state
                        raise ValueError(
                            f"{p}: {len(toks)} columns per line; this "
                            "loader reads 'weight [acc]' dumps (sgd/"
                            "adagrad layouts), not multi-slot accessors")
                    w.append(float(toks[0]))
                    acc.append(float(toks[1]) if len(toks) > 1 else 0.0)
        if len(w) != self.size:
            raise ValueError(
                f"dump has {len(w)} values; table size is {self.size}")
        self.assign(np.array(w, np.float32))
        self.assign_acc(np.array(acc, np.float32))
        return len(w)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.ps_dense_free(self._h)
        except Exception:
            pass


class SparseTable:
    """id -> embedding row, lazily initialized; async server-side updates."""

    def __init__(self, dim: int, optimizer="adagrad", lr=0.05, epsilon=1e-6,
                 seed=0, init_range=0.05):
        self.dim = int(dim)
        self.optimizer = _OPT[optimizer]
        self.lr = float(lr)
        self.epsilon = float(epsilon)
        self.seed = int(seed)  # persisted in snapshots: lazy init of ids
        self.init_range = float(init_range)  # first pulled AFTER a restore
        # must match what the original table would have produced
        lib = _lib()
        if lib is not None:
            self._h = lib.ps_sparse_new(self.dim, seed, init_range)
            self._lib = lib
        else:
            self._h = None
            self._rows: dict[int, np.ndarray] = {}
            self._g2: dict[int, np.ndarray] = {}
            self._rng = np.random.RandomState(seed)
            self._init_range = init_range
            self._mu = threading.Lock()

    def _row(self, i: int) -> np.ndarray:
        if i not in self._rows:
            self._rows[i] = self._rng.uniform(
                -self._init_range, self._init_range, self.dim).astype(np.float32)
            self._g2[i] = np.zeros(self.dim, np.float32)
        return self._rows[i]

    def pull(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        out = np.empty((ids.size, self.dim), np.float32)
        if self._h:
            self._lib.ps_sparse_pull(self._h, _i64p(ids), ids.size, _f32p(out))
        else:
            with self._mu:
                for k, i in enumerate(ids):
                    out[k] = self._row(int(i))
        return out

    def push_grad(self, ids: np.ndarray, grads: np.ndarray):
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        g = np.ascontiguousarray(grads, np.float32).reshape(ids.size, self.dim)
        if self._h:
            self._lib.ps_sparse_push_grad(self._h, _i64p(ids), ids.size, _f32p(g),
                                          self.optimizer, self.lr, self.epsilon)
        else:
            with self._mu:
                for k, i in enumerate(ids):
                    row = self._row(int(i))
                    if self.optimizer == ADAGRAD:
                        self._g2[int(i)] += g[k] * g[k]
                        row -= self.lr * g[k] / (np.sqrt(self._g2[int(i)]) + self.epsilon)
                    else:
                        row -= self.lr * g[k]

    def size(self) -> int:
        if self._h:
            return int(self._lib.ps_sparse_size(self._h))
        with self._mu:
            return len(self._rows)

    def assign_rows(self, ids: np.ndarray, values: np.ndarray):
        """Overwrite exact row values (snapshot restore — the Load side of
        export(); accumulators reset)."""
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        values = np.ascontiguousarray(values, np.float32).reshape(
            ids.size, self.dim)
        if self._h:
            self._lib.ps_sparse_assign(self._h, _i64p(ids), ids.size,
                                       _f32p(values))
            return
        with self._mu:
            for j, i in enumerate(ids):
                self._rows[int(i)] = values[j].copy()
                self._g2[int(i)] = np.zeros(self.dim, np.float32)

    def erase(self, ids: np.ndarray) -> int:
        """Remove rows by id; returns how many existed (native
        ps_sparse_erase — the shrink primitive)."""
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        if self._h:
            return int(self._lib.ps_sparse_erase(self._h, _i64p(ids), ids.size))
        with self._mu:
            n = 0
            for i in ids:
                n += self._rows.pop(int(i), None) is not None
                self._g2.pop(int(i), None)
            return n

    def export(self):
        """(ids, rows) snapshot for checkpointing. Retries while concurrent
        pushes grow the table so a live-training snapshot is not silently
        truncated (size() and the shard walk are not atomic)."""
        if self._h:
            for _ in range(5):
                cap = self.size()
                ids = np.empty(cap, np.int64)
                emb = np.empty((max(cap, 1), self.dim), np.float32)
                n = int(self._lib.ps_sparse_export(self._h, _i64p(ids),
                                                   _f32p(emb), cap))
                if self.size() == n:
                    return ids[:n], emb[:n]
            return ids[:n], emb[:n]  # table still growing: best effort
        with self._mu:
            ids = np.array(sorted(self._rows), np.int64)
            return ids, np.stack([self._rows[int(i)] for i in ids]) if ids.size \
                else np.zeros((0, self.dim), np.float32)

    def export_state(self):
        """(ids, rows, accumulators): the FULL per-row state — checkpoint
        restore resumes the optimizer trajectory instead of resetting it."""
        if self._h:
            for _ in range(5):
                cap = self.size()
                ids = np.empty(cap, np.int64)
                emb = np.empty((max(cap, 1), self.dim), np.float32)
                acc = np.empty((max(cap, 1), self.dim), np.float32)
                n = int(self._lib.ps_sparse_export_state(
                    self._h, _i64p(ids), _f32p(emb), _f32p(acc), cap))
                if self.size() == n:
                    break
            return ids[:n], emb[:n], acc[:n]
        with self._mu:
            ids = np.array(sorted(self._rows), np.int64)
            if not ids.size:
                z = np.zeros((0, self.dim), np.float32)
                return ids, z, z.copy()
            return (ids, np.stack([self._rows[int(i)] for i in ids]),
                    np.stack([self._g2[int(i)] for i in ids]))

    def assign_state(self, ids, rows, acc):
        """Inverse of export_state: exact embeddings AND accumulators."""
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        rows = np.ascontiguousarray(rows, np.float32).reshape(ids.size,
                                                              self.dim)
        acc = np.ascontiguousarray(acc, np.float32).reshape(ids.size,
                                                            self.dim)
        if self._h:
            self._lib.ps_sparse_assign_state(self._h, _i64p(ids), ids.size,
                                             _f32p(rows), _f32p(acc))
            return
        with self._mu:
            for j, i in enumerate(ids):
                self._rows[int(i)] = rows[j].copy()
                self._g2[int(i)] = acc[j].copy()

    # --------------------------------------- reference text-format interop
    def save_text(self, dirname, table_id=0, mode=0, shard=0):
        """Write the table in the reference PS dump layout
        (memory_sparse_table.cc:332 SaveLocalFS): one line per feature,
        `"<key> <values...>"`, in `<dirname>/<table_id>/part-<shard:03d>-00000`.
        mode 0 saves weights + optimizer accumulators (resume-exact);
        mode 3 saves weights only (the reference's save-for-inference
        param, ctr_accessor.cc Save params batch-model convention)."""
        import os

        if mode not in (0, 3):
            raise ValueError(
                f"save_text mode {mode!r} not supported: 0 (resume-exact, "
                "weights+accumulators) or 3 (weights-only/inference)")
        table_dir = os.path.join(str(dirname), str(table_id))
        os.makedirs(table_dir, exist_ok=True)
        path = os.path.join(table_dir, f"part-{shard:03d}-00000")
        ids, rows, acc = self.export_state()
        with open(path, "w") as f:
            for j, fid in enumerate(ids):
                vals = list(rows[j])
                if mode == 0:
                    vals += list(acc[j])
                f.write(f"{int(fid)} " +
                        " ".join(f"{v:.9g}" for v in vals) + "\n")
        return path

    def load_text(self, dirname, table_id=0, clear=True):
        """Inverse of save_text: read every part-* file of the table dir.
        Tolerates both our dumps and reference-written lines whose value
        count is dim (weights-only — accumulators reset) or 2*dim (with
        accumulators). `clear=True` (default) erases rows not present in
        the dump first, so the restore is checkpoint-consistent rather than
        a merge of two training runs; pass clear=False to intentionally
        overlay a dump onto live state."""
        import glob
        import os

        table_dir = os.path.join(str(dirname), str(table_id))
        parts = sorted(glob.glob(os.path.join(table_dir, "part-*")))
        if not parts:
            raise FileNotFoundError(f"no part-* files under {table_dir}")
        ids, rows, accs = [], [], []
        for p in parts:
            with open(p) as f:
                for line in f:
                    toks = line.split()
                    if not toks:
                        continue
                    fid, vals = int(toks[0]), [float(t) for t in toks[1:]]
                    if len(vals) not in (self.dim, 2 * self.dim):
                        raise ValueError(
                            f"{p}: feature {fid} has {len(vals)} values; "
                            f"expected dim={self.dim} or 2*dim")
                    ids.append(fid)
                    rows.append(vals[: self.dim])
                    accs.append(vals[self.dim:] if len(vals) == 2 * self.dim
                                else [0.0] * self.dim)
        if clear:
            existing, _ = self.export()
            stale = np.setdiff1d(existing, np.array(ids, np.int64))
            if stale.size:
                self.erase(stale)
        self.assign_state(np.array(ids, np.int64),
                          np.array(rows, np.float32),
                          np.array(accs, np.float32))
        return len(ids)

    def __del__(self):  # noqa: D105
        try:
            if getattr(self, "_h", None):
                self._lib.ps_sparse_free(self._h)
        except Exception:
            pass


class CtrAccessor:
    """CTR feature-value accessor over a SparseTable.

    Reference analog: CtrCommonAccessor + MemorySparseTable::Shrink
    (paddle/fluid/distributed/ps/table/memory_sparse_table.cc,
    ctr_accessor.cc): every sparse feature carries show/click counters; a
    feature's score = show_coeff*show + click_coeff*click decays every pass,
    and Shrink evicts features whose score falls under a threshold — this is
    what keeps billion-feature CTR tables bounded.
    """

    def __init__(self, table: SparseTable, show_coeff=0.25, click_coeff=9.0,
                 decay_rate=0.98):
        self.table = table
        self.show_coeff = float(show_coeff)
        self.click_coeff = float(click_coeff)
        self.decay_rate = float(decay_rate)
        self._show: dict[int, float] = {}
        self._click: dict[int, float] = {}
        self._mu = threading.Lock()

    def update(self, ids, shows=None, clicks=None):
        """Record impressions/clicks for the batch's feature ids."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        shows = np.ones(ids.size) if shows is None else np.asarray(shows).reshape(-1)
        clicks = np.zeros(ids.size) if clicks is None else np.asarray(clicks).reshape(-1)
        with self._mu:
            for i, s, c in zip(ids, shows, clicks):
                self._show[int(i)] = self._show.get(int(i), 0.0) + float(s)
                self._click[int(i)] = self._click.get(int(i), 0.0) + float(c)

    def score(self, fid: int) -> float:
        return (self.show_coeff * self._show.get(int(fid), 0.0)
                + self.click_coeff * self._click.get(int(fid), 0.0))

    def decay(self):
        """End-of-pass decay (reference show_click_decay_rate)."""
        with self._mu:
            for d in (self._show, self._click):
                for k in d:
                    d[k] *= self.decay_rate

    def shrink(self, threshold: float) -> int:
        """Evict every feature whose score < threshold from the table;
        returns the eviction count (MemorySparseTable::Shrink)."""
        with self._mu:
            ids, _ = self.table.export()
            evict = np.array([i for i in ids if self.score(int(i)) < threshold],
                             np.int64)
            removed = self.table.erase(evict) if evict.size else 0
            for i in evict:
                self._show.pop(int(i), None)
                self._click.pop(int(i), None)
        return removed


class SsdSparseTable:
    """Disk-spilling sparse table: a bounded hot cache in RAM, cold rows on
    an append-only file with an offset index.

    Reference analog: SSDSparseTable
    (paddle/fluid/distributed/ps/table/ssd_sparse_table.cc —
    rocksdb-backed rows behind a memory cache) — the mechanism that lets CTR
    tables exceed RAM. Here the store is an append-only .bin + offset dict
    (compaction on save); eviction is LRU.
    """

    def __init__(self, dim: int, path: str, cache_rows: int = 100_000,
                 optimizer="sgd", lr=0.05, epsilon=1e-6, seed=0,
                 init_range=0.05):
        import collections
        import os

        self.dim = int(dim)
        self.optimizer = _OPT[optimizer]
        self.lr = float(lr)
        self.epsilon = float(epsilon)
        self.path = path
        self.cache_rows = int(cache_rows)
        if self.cache_rows < 1:
            raise ValueError("cache_rows must be >= 1 (a 0-row cache would "
                             "silently drop every in-place update)")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._file = open(path, "a+b")
        self._offsets: dict[int, int] = {}  # id -> byte offset of latest row
        if os.path.exists(path + ".idx"):  # restart: recover the last save()
            import json

            with open(path + ".idx") as f:
                self._offsets = {int(k): v for k, v in json.load(f).items()}
        self._hot: "collections.OrderedDict[int, np.ndarray]" = \
            collections.OrderedDict()
        self._dirty: set[int] = set()
        self._rng = np.random.RandomState(seed)
        self._init_range = init_range
        self._mu = threading.Lock()
        # adagrad co-stores its accumulator after the weights in each record
        self._width = self.dim * (2 if self.optimizer == ADAGRAD else 1)
        self._row_bytes = self._width * 4

    # ---------------------------------------------------------------- disk io
    def _spill(self, fid: int, row: np.ndarray):
        if fid in self._offsets and fid not in self._dirty:
            return  # clean row already on disk: no append (read-only safety)
        self._file.seek(0, 2)
        off = self._file.tell()
        self._file.write(row.astype(np.float32).tobytes())
        self._offsets[fid] = off
        self._dirty.discard(fid)

    def _load(self, fid: int) -> np.ndarray:
        self._file.seek(self._offsets[fid])
        return np.frombuffer(self._file.read(self._row_bytes),
                             np.float32).copy()

    def _evict_if_needed(self):
        while len(self._hot) > self.cache_rows:
            fid, row = self._hot.popitem(last=False)  # LRU
            self._spill(fid, row)

    def _row(self, fid: int) -> np.ndarray:
        if fid in self._hot:
            self._hot.move_to_end(fid)
            return self._hot[fid]
        if fid in self._offsets:
            row = self._load(fid)
        else:
            row = np.zeros(self._width, np.float32)
            row[: self.dim] = self._rng.uniform(
                -self._init_range, self._init_range, self.dim)
            self._dirty.add(fid)  # fresh row exists only in RAM
        self._hot[fid] = row
        self._evict_if_needed()
        return row

    # ------------------------------------------------------------- table API
    def pull(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return np.empty((0, self.dim), np.float32)
        with self._mu:
            return np.stack([self._row(int(i))[: self.dim] for i in ids])

    def push_grad(self, ids: np.ndarray, grads: np.ndarray):
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        g = np.ascontiguousarray(grads, np.float32).reshape(ids.size, self.dim)
        with self._mu:
            for k, i in enumerate(ids):
                row = self._row(int(i))  # mutated in place (it IS the cached obj)
                if self.optimizer == ADAGRAD:
                    row[self.dim:] += g[k] * g[k]
                    row[: self.dim] -= self.lr * g[k] / (
                        np.sqrt(row[self.dim:]) + self.epsilon)
                else:
                    row[: self.dim] -= self.lr * g[k]
                self._dirty.add(int(i))

    def size(self) -> int:
        with self._mu:
            return len(set(self._hot) | set(self._offsets))

    def hot_rows(self) -> int:
        return len(self._hot)

    def save(self, path: str | None = None):
        """No arg: compact the live store in place (dedups append history).
        With a path: write a checkpoint COPY there — the live table keeps its
        own backing file (a checkpoint must not move the working store)."""
        import os

        checkpoint = path is not None and path != self.path
        target = path or self.path
        tmp = target + ".compact"
        with self._mu:
            all_ids = sorted(set(self._hot) | set(self._offsets))
            new_offsets = {}
            with open(tmp, "wb") as out:
                for fid in all_ids:
                    row = (self._hot[fid] if fid in self._hot
                           else self._load(fid))
                    new_offsets[fid] = out.tell()
                    out.write(row.astype(np.float32).tobytes())
            os.replace(tmp, target)
            import json

            with open(target + ".idx.tmp", "w") as f:  # restartable index
                json.dump({str(k): v for k, v in new_offsets.items()}, f)
            os.replace(target + ".idx.tmp", target + ".idx")
            if not checkpoint:
                self._file.close()
                self._file = open(target, "a+b")
                self._offsets = new_offsets
                self._hot.clear()
                self._dirty.clear()

    def erase(self, ids: np.ndarray) -> int:
        """Drop rows (CtrAccessor.shrink contract); file space reclaims at the
        next compaction."""
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        with self._mu:
            n = 0
            for i in ids:
                i = int(i)
                had = i in self._hot or i in self._offsets
                self._hot.pop(i, None)
                self._offsets.pop(i, None)
                self._dirty.discard(i)
                n += had
            return n

    def export(self):
        """(ids, rows) snapshot — same contract as SparseTable.export, so
        CtrAccessor composes with the disk tier too."""
        with self._mu:
            all_ids = np.array(sorted(set(self._hot) | set(self._offsets)),
                               np.int64)
            if not all_ids.size:
                return all_ids, np.zeros((0, self.dim), np.float32)
            rows = np.stack([
                (self._hot[int(i)] if int(i) in self._hot
                 else self._load(int(i)))[: self.dim]
                for i in all_ids])
            return all_ids, rows

    def close(self):
        try:
            self._file.close()
        except Exception:
            pass


# ---- sparse-table entry policies (reference: the_one_ps.py Entry configs:
# show-click/probability/count-filter admission of new embedding ids) ----
class Entry:
    def attr(self) -> str:
        raise NotImplementedError


class CountFilterEntry(Entry):
    """Admit an id into the sparse table only after `count_filter` hits."""

    def __init__(self, count_filter=5):
        if count_filter < 0:
            raise ValueError("count_filter must be >= 0")
        self._count = int(count_filter)

    def attr(self):
        return f"count_filter_entry:{self._count}"


class ProbabilityEntry(Entry):
    """Admit new ids with the given probability."""

    def __init__(self, probability=1.0):
        if not 0 <= probability <= 1:
            raise ValueError("probability must be in [0, 1]")
        self._probability = float(probability)

    def attr(self):
        return f"probability_entry:{self._probability}"


class ShowClickEntry(Entry):
    """Weight admission by show/click slot statistics."""

    def __init__(self, show_name, click_name):
        self._show = str(show_name)
        self._click = str(click_name)

    def attr(self):
        return f"show_click_entry:{self._show}:{self._click}"
