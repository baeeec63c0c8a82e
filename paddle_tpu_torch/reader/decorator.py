"""Reader decorators (reference: ``paddle_tpu/reader/decorator.py``;
Paddle's ``python/paddle/reader/decorator.py:52-688``).

Pure-Python composition over the reader-creator protocol. The threaded
and multiprocess variants keep the reference's worker and queue shapes (a
thread pool with an end-signal sentinel; forked processes feeding a
multiprocessing queue or pipes): feeding runs on the host whatever the
accelerator.
"""
from __future__ import annotations

import itertools
import random
import time
from itertools import zip_longest
from queue import Queue
from threading import Thread

__all__ = []


class ComposeNotAligned(ValueError):
    pass


def cache(reader):
    """Cache the first full pass in memory; later passes replay it
    (reference: decorator.py:52)."""
    all_data = tuple(reader())

    def __impl__():
        for item in all_data:
            yield item

    return __impl__


def map_readers(func, *readers):
    """Element-wise map over zipped readers (reference: decorator.py:92)."""

    def reader():
        rs = []
        for r in readers:
            rs.append(r())
        for e in map(func, *rs):
            yield e

    return reader


def shuffle(reader, buf_size):
    """Buffered shuffle (reference: decorator.py:134): fill a buf_size
    window, shuffle it, emit, repeat; tail window shuffled too."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if len(buf) > 0:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """Concatenate readers back to back (reference: decorator.py:183)."""

    def reader():
        rs = []
        for r in readers:
            rs.append(r())
        for e in itertools.chain(*rs):
            yield e

    return reader


def compose(*readers, **kwargs):
    """Zip readers into flattened tuples (reference: decorator.py:248).

    check_alignment=True (default) raises ComposeNotAligned when readers have
    different lengths; False silently truncates to the shortest.
    """
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = []
        for r in readers:
            rs.append(r())
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in zip_longest(*rs):
                for o in outputs:
                    if o is None:
                        raise ComposeNotAligned(
                            "outputs of readers are not aligned."
                        )
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


def buffered(reader, size):
    """Read-ahead buffer filled by a background thread
    (reference: decorator.py:308)."""

    class EndSignal:
        pass

    end = EndSignal()

    def read_worker(r, q):
        for d in r:
            q.put(d)
        q.put(end)

    def data_reader():
        r = reader()
        q = Queue(maxsize=size)
        t = Thread(target=read_worker, args=(r, q))
        t.daemon = True
        t.start()
        e = q.get()
        while e is not end:
            yield e
            e = q.get()

    return data_reader


def firstn(reader, n):
    """First n samples only (reference: decorator.py:367)."""

    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


class XmapEndSignal:
    pass


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Thread-pool map over a reader (reference: decorator.py:412) —
    process_num handler threads pull from an input queue, push mapped
    samples to an output queue; order=True serializes emission by an
    in-order ticket so output order matches input order."""
    end = XmapEndSignal()

    def read_worker(reader, in_queue):
        for i in reader():
            in_queue.put(i)
        in_queue.put(end)

    def order_read_worker(reader, in_queue):
        in_order = 0
        for i in reader():
            in_queue.put((in_order, i))
            in_order += 1
        in_queue.put(end)

    def handle_worker(in_queue, out_queue, mapper):
        sample = in_queue.get()
        while not isinstance(sample, XmapEndSignal):
            r = mapper(sample)
            out_queue.put(r)
            sample = in_queue.get()
        in_queue.put(end)
        out_queue.put(end)

    def order_handle_worker(in_queue, out_queue, mapper, out_order, lock):
        ins = in_queue.get()
        while not isinstance(ins, XmapEndSignal):
            order, sample = ins
            r = mapper(sample)
            # the reference busy-waits on out_order[0]; yield the GIL while
            # waiting for our ticket so other handler threads make progress
            while True:
                with lock:
                    if order == out_order[0]:
                        out_queue.put(r)
                        out_order[0] += 1
                        break
                time.sleep(0.0005)
            ins = in_queue.get()
        in_queue.put(end)
        out_queue.put(end)

    def xreader():
        import threading

        in_queue = Queue(buffer_size)
        out_queue = Queue(buffer_size)
        out_order = [0]
        lock = threading.Lock()
        target = order_read_worker if order else read_worker
        t = Thread(target=target, args=(reader, in_queue))
        t.daemon = True
        t.start()
        target = order_handle_worker if order else handle_worker
        args = (
            (in_queue, out_queue, mapper, out_order, lock)
            if order
            else (in_queue, out_queue, mapper)
        )
        workers = []
        for _ in range(process_num):
            worker = Thread(target=target, args=args)
            worker.daemon = True
            workers.append(worker)
        for w in workers:
            w.start()

        sample = out_queue.get()
        while not isinstance(sample, XmapEndSignal):
            yield sample
            sample = out_queue.get()
        finish = 1
        while finish < process_num:
            sample = out_queue.get()
            if isinstance(sample, XmapEndSignal):
                finish += 1
            else:
                yield sample

    return xreader


def _reap(procs):
    """Join the reader processes: those done have sent their end mark; one
    still writing (the caller stopped early, or another reader failed)
    would block on a full queue or pipe, so it is terminated first."""
    for p in procs:
        p.join(timeout=1.0)
        if p.is_alive():
            p.terminate()
            p.join()


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Fork one process per reader, merge via a multiprocessing queue or
    pipes (reference: decorator.py:505). Samples must be picklable; the
    readers need not be (the processes are forked, as in the reference).
    The processes are joined when the merged reader ends or is closed."""
    import multiprocessing as mp

    if len(readers) < 1:
        raise ValueError("readers number must be greater than 0!")

    def _read_into_queue(reader, queue):
        try:
            for sample in reader():
                if sample is None:
                    raise ValueError("sample has None")
                queue.put(sample)
            queue.put(None)
        except Exception:
            queue.put("")
            raise

    def queue_reader():
        queue = mp.Queue(queue_size)
        procs = [mp.Process(target=_read_into_queue, args=(reader, queue))
                 for reader in readers]
        for p in procs:
            p.start()
        try:
            finish_num = 0
            while finish_num < len(readers):
                sample = queue.get()
                if sample is None:
                    finish_num += 1
                elif sample == "":
                    raise ValueError("multiprocess reader raises an exception")
                else:
                    yield sample
        finally:
            _reap(procs)

    def _read_into_pipe(reader, conn):
        try:
            for sample in reader():
                if sample is None:
                    raise ValueError("sample has None!")
                conn.send(sample)
            conn.send(None)
        except Exception:
            conn.send("")
            raise
        finally:
            conn.close()

    def pipe_reader():
        conns, procs = [], []
        for reader in readers:
            parent_conn, child_conn = mp.Pipe()
            conns.append(parent_conn)
            procs.append(mp.Process(target=_read_into_pipe,
                                    args=(reader, child_conn)))
            procs[-1].start()
        try:
            finish_num = 0
            conn_to_remove = []
            while finish_num < len(readers):
                for conn in conn_to_remove:
                    conns.remove(conn)
                conn_to_remove = []
                for conn in conns:
                    sample = conn.recv()
                    if sample is None:
                        finish_num += 1
                        conn.close()
                        conn_to_remove.append(conn)
                    elif sample == "":
                        conn.close()
                        conn_to_remove.append(conn)
                        raise ValueError(
                            "multiprocess reader raises an exception")
                    else:
                        yield sample
        finally:
            _reap(procs)

    if use_pipe:
        return pipe_reader
    return queue_reader
