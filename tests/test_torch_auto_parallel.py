"""Auto-parallel of the port (``paddle_tpu_torch.distributed.auto_parallel``)
against the JAX package's, module by module:

- ``ProcessMesh`` (shape, equality, its errors, the rank groups and
  topology that stand in for ``jax_mesh``), ``normalize_spec``'s errors
  and the ``Partitioner``'s relaxations, batch placement and per-parameter
  specs, each equal to the reference's;
- ``Cluster``'s JSON (both schemas, the ``"h100"`` row), ``axis_medium``
  and ``map_mesh``, with ``tests/test_serving.py``'s two hosts of six;
- the planner (``plan_mesh``, ``plan_parallel``, ``estimate_step_time``)
  over a grid that holds the reference tests' cases (the wide FFN, the
  long sequence, GPT-6.7B on v5p-64): plans, candidates and times equal
  to float rounding;
- ``CompCostModel.analyze`` on a matmul: 2mkn FLOPs;
- ``complete_param_specs`` on the reference test's tiny GPT, a tiny BERT
  and an MLP, and ``complete`` on the reference test's ``f``: equal to
  the reference's completion;
- on four gloo ranks (``tests/test_torch_auto_parallel_ranks.py``, one
  spawn for the module): ``shard_tensor`` / ``local_shard`` / ``reshard``
  round trips and ``Resharder.log``; the Engine, completed and with
  ``apply_megatron_specs``, against the reference's Engine on a 2 x 2
  mesh within 1e-5; ``fit`` / ``evaluate`` / ``predict`` / ``save`` /
  ``load`` against the reference's; and the workflow of
  ``examples/auto_parallel_plan.py`` (which imports ``jax.sharding``, so
  it cannot run against the port) at four ranks: its plan, placement and
  six losses.
"""
import importlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import paddle_tpu as J
from paddle_tpu.distributed import auto_parallel as JA
from paddle_tpu.distributed.auto_parallel import cluster as JC
from paddle_tpu.distributed.auto_parallel import planner as JPL
from paddle_tpu_torch.distributed import auto_parallel as TA
from paddle_tpu_torch.distributed.auto_parallel import cluster as TC
from paddle_tpu_torch.distributed.auto_parallel import planner as TPL
from test_torch_auto_parallel_ranks import (GPT, GPT_BATCH, GPT_LR,
                                            GPT_STEPS, MLP_EPOCHS,
                                            MLP_LOG_FREQ, MLP_LR, FFN,
                                            PLAN_DESC, PLAN_LR, PLAN_STEPS,
                                            SPAWN_TIMEOUT_S, WORLD, ap_rank)

# the modules (the packages' ``reshard`` names the function)
JR = importlib.import_module("paddle_tpu.distributed.auto_parallel.reshard")
TR = importlib.import_module(
    "paddle_tpu_torch.distributed.auto_parallel.reshard")
LOSS_RTOL = 1e-5


# ------------------------------------------------------------ ProcessMesh
def test_process_mesh_matches_the_reference():
    ids = np.arange(8).reshape(2, 4)
    ref = JA.ProcessMesh(ids, dim_names=["dp", "mp"])
    port = TA.ProcessMesh(ids, dim_names=["dp", "mp"])
    for attr in ("shape", "ndim", "size", "process_ids", "processes",
                 "dim_names"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.get_dim_size("mp") == ref.get_dim_size("mp") == 4
    assert port == TA.ProcessMesh([[0, 1, 2, 3], [4, 5, 6, 7]],
                                  dim_names=["dp", "mp"])
    assert hash(port) == hash(TA.ProcessMesh(ids, dim_names=["dp", "mp"]))
    assert repr(port) == repr(ref)
    for mod in (JA, TA):
        with pytest.raises(ValueError):
            mod.ProcessMesh(np.arange(4), dim_names=["a", "b"])
    # the reference raises at jax_mesh() when an id outruns the devices;
    # the port when its groups are made over fewer ranks
    with pytest.raises(ValueError):
        JA.ProcessMesh(np.arange(16), dim_names=["x"]).jax_mesh()
    with pytest.raises(ValueError):
        TA.ProcessMesh(np.arange(16), dim_names=["x"]).check_world(8)


def test_process_mesh_groups_follow_the_ids_array():
    """A permuted mesh (the mapper's transposition): the rank groups and
    the topology's coordinates come from the ids array, never arange."""
    ids = np.array([[0, 2], [1, 3]])
    pm = TA.ProcessMesh(ids, dim_names=["dp", "mp"])
    assert pm.rank_groups("mp") == [[0, 2], [1, 3]]
    assert pm.rank_groups("dp") == [[0, 1], [2, 3]]
    assert pm.coordinate(2) == (0, 1) and pm.coordinate(9) is None
    topo = pm.topology()
    assert topo.get_comm_list("model") == [[0, 2], [1, 3]]
    assert topo.get_coord(1) == {"data": 1, "model": 0}
    jm = JA.ProcessMesh(ids, dim_names=["dp", "mp"]).jax_mesh()
    devs = np.vectorize(lambda d: d.id)(jm.devices)
    assert (devs == ids).all()   # the reference's device ids, the same grid
    with pytest.raises(ValueError):
        TA.ProcessMesh(ids, dim_names=["dp", "sp"]).topology()


@pytest.mark.parametrize("spec,ndim", [(["x", None], 2), (None, 3),
                                       (["nope", None], 2), (["x"], 2),
                                       (["y", "x"], 2)])
def test_normalize_spec_matches_the_reference(spec, ndim):
    names = ["x", "y"]
    try:
        want = JR.normalize_spec(spec, ndim, names)
    except ValueError:
        with pytest.raises(ValueError):
            TR.normalize_spec(spec, ndim, names)
        return
    assert TR.normalize_spec(spec, ndim, names) == want


def _ref_partitioner():
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("dp", "mp"))
    return JA.Partitioner(mesh)


@pytest.mark.parametrize("shape,spec", [
    ((8, 16), (None, "mp")), ((8, 6), (None, "mp")), ((8, 16), (None, "nope")),
    ((8, 16), ("dp", "mp")), ((7, 16), ("dp", None)), ((8,), ("mp",)),
    ((8, 16), None), ((4, 4, 4), ("dp",))])
def test_partitioner_relaxes_as_the_reference(shape, spec):
    port = TA.Partitioner(TA.ProcessMesh(np.arange(8).reshape(2, 4),
                                         dim_names=["dp", "mp"]))
    want = tuple(_ref_partitioner().validate_spec(shape, spec))
    assert port.validate_spec(shape, spec) == want


def test_partitioner_batch_and_params_match_the_reference():
    ids = np.arange(8).reshape(2, 2, 2)
    names = ["dp", "sharding", "mp"]
    ref = JA.Partitioner(Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2),
                              tuple(names)))
    port = TA.Partitioner(TA.ProcessMesh(ids, dim_names=names))
    for nd in (0, 1, 3):
        assert port.partition_batch(nd).spec == tuple(
            ref.partition_batch(nd).spec) + (None,) * (
            nd - len(ref.partition_batch(nd).spec))
    jm, tm = _tiny_gpts()
    for mod in (jm, tm):
        for name, p in mod.named_parameters():
            if name.endswith(("qkv_proj.weight", "fc1.weight")):
                p._sharding_spec = (None, "mp")
            if name.endswith("fc2.weight"):
                p._sharding_spec = ("mp", None)
            if name.endswith("wpe.weight"):
                p._sharding_spec = ("sharding", "nope")
    want = {k: tuple(v.spec) for k, v in ref.partition_params(jm).items()}
    got = port.partition_params(tm)
    assert {k: v.spec for k, v in got.items()} == want
    assert got["gpt.blocks.0.mlp.fc1.weight"].local_shape((16, 64)) == (16, 32)


# ---------------------------------------------------- cluster and mapper
def test_cluster_json_and_links_match_the_reference():
    for kw in (dict(accelerator_type="v5p", n_hosts=4, chips_per_host=4,
                    dcn_bandwidth=50e9),
               dict(accelerator_type="v5e", n_hosts=2, chips_per_host=8)):
        ref, port = JC.Cluster(**kw), TC.Cluster(**kw)
        assert port.to_json() == ref.to_json()
        assert TC.Cluster.from_json(ref.to_json()) == port
        assert vars(port.to_cluster_spec()) == vars(ref.to_cluster_spec())
        for a, b in ((0, 3), (3, 4), (0, 0)):
            assert port.bandwidth(a, b) == ref.bandwidth(a, b)
        for n, s in ((4, 1), (4, 4), (2, 8), (16, 1)):
            assert port.axis_medium(n, s) == ref.axis_medium(n, s)
    ref_json = ('{"machines": [{"hostname": "a", "devices": '
                '[{"type": "V5P"}, {"type": "V5P"}]}]}')
    assert TC.Cluster.from_json(ref_json).to_json() == \
        JC.Cluster.from_json(ref_json).to_json()
    for k, row in JC.DEVICE_SPECS.items():  # every reference row kept
        assert TC.DEVICE_SPECS[k] == row
    h100 = ('{"machines": [{"devices": [{"type": "NVIDIA H100 80GB HBM3"}]'
            ' * 1}, {"devices": [{"type": "NVIDIA H100 80GB HBM3"}]}]}')
    c = TC.Cluster.from_json(h100.replace(" * 1", ""))
    assert c.accelerator_type == "h100" and c.n_hosts == 2
    spec = TC.Cluster("h100", 1, 4).to_cluster_spec()
    assert spec.peak_flops == 989e12 and spec.hbm_bytes == 80e9


def test_axis_medium_and_mapper_on_two_hosts_of_six():
    """``tests/test_serving.py``'s: a group of two strided two straddles
    the hosts on a six-chip host."""
    ref = JC.Cluster(accelerator_type="v5p", n_hosts=2, chips_per_host=6)
    port = TC.Cluster(accelerator_type="v5p", n_hosts=2, chips_per_host=6)
    cases = [((2,), dict(stride=2)), ((6,), dict(stride=1)),
             ((2,), dict(stride=6)), ((4,), dict(stride=4)),
             ((2,), dict(stride=2, groups=[[0, 2], [1, 3]])),
             ((2,), dict(stride=2, groups=[[4, 6]]))]
    for a, kw in cases:
        assert port.axis_medium(*a, **kw) == ref.axis_medium(*a, **kw)
    from paddle_tpu.distributed.auto_parallel.mapper import map_mesh as jmap
    from paddle_tpu_torch.distributed.auto_parallel.mapper import (
        map_mesh as tmap)

    for sizes, comm in (({"dp": 2, "mp": 6}, {"mp": 2.0, "dp": 1.0}),
                        ({"dp": 2, "mp": 6}, {"mp": 1.0, "dp": 2.0}),
                        ({"dp": 3, "mp": 4}, None),
                        ({"dp": 2, "sp": 2, "sharding": 1, "mp": 3}, None)):
        ids, pl = tmap(port, sizes, comm)
        rids, rpl = jmap(ref, sizes, comm)
        assert (ids == rids).all() and pl == rpl
    pm = TA.build_process_mesh(port, {"dp": 2, "mp": 6},
                               {"mp": 2.0, "dp": 1.0})
    assert pm.placement == {"mp": "ici", "dp": "dcn"}


# ------------------------------------------------------------- the planner
_GRID = [  # (n_devices, ModelDesc fields, cluster)
    (8, dict(n_params=8_400_000, layers=2, hidden=512, heads=8, seq=32,
             batch=8), "cpu8"),                               # the wide FFN
    (8, dict(n_params=1_600_000, layers=2, hidden=128, heads=8, seq=2048,
             batch=2), "cpu8"),                               # long sequence
    (8, dict(n_params=4_300_000, layers=1, hidden=512, heads=0, seq=1,
             batch=8), "cpu8"),                   # examples/auto_parallel_plan
    (64, dict(n_params=6_700_000_000, layers=32, hidden=4096, heads=32,
              seq=2048, batch=64), "v5p-16x4"),           # GPT-6.7B, v5p-64
    (4, dict(n_params=354_000_000, layers=24, hidden=1024, heads=16,
             seq=1024, batch=8), "h100-1x4"),             # GPT-350M, H100
    (32, dict(n_params=354_000_000, layers=24, hidden=1024, heads=16,
              seq=1024, batch=64), "h100-4x8"),
    (16, dict(n_params=50_000_000, layers=2, hidden=1024, heads=8, seq=32,
              batch=8), "v5p-2x8"),
    (2, dict(n_params=10_000, layers=1, hidden=16, heads=2, seq=8, batch=4),
     "cpu2"),
]


def _cluster(mod, name):
    if name.startswith("cpu"):
        return mod.cpu_test_cluster(int(name[3:]))
    kind, hw = name.split("-")
    hosts, chips = (int(v) for v in hw.split("x"))
    return mod.Cluster(kind, hosts, chips)


def _no_h100(name):
    return name.startswith("h100")


@pytest.mark.parametrize("case", range(len(_GRID)))
def test_plan_parallel_matches_the_reference(case):
    n, fields, cname = _GRID[case]
    port = TPL.plan_parallel(n, TA.ModelDesc(**fields),
                             _cluster(TC, cname))
    if _no_h100(cname):   # the reference has no h100 row: the same numbers
        ref_cl = JC.Cluster("v5p", *(int(v) for v in cname.split("-")[1]
                                     .split("x")),
                            overrides=dict(TC.DEVICE_SPECS["h100"]))
    else:
        ref_cl = _cluster(JC, cname)
    ref = JPL.plan_parallel(n, JA.ModelDesc(**fields), ref_cl)
    assert port.axis_sizes == ref.axis_sizes
    assert port.time == pytest.approx(ref.time, rel=1e-12)
    assert port.per_chip_bytes == pytest.approx(ref.per_chip_bytes,
                                                rel=1e-12)
    assert port.t_comm == pytest.approx(ref.t_comm, rel=1e-12)
    assert len(port.candidates) == len(ref.candidates)
    for a, b in zip(port.candidates, ref.candidates):
        for k in ("dp", "sp", "sharding", "mp", "feasible"):
            assert a[k] == b[k]
        assert a["t_eff"] == pytest.approx(b["t_eff"], rel=1e-12)
    pm = port.process_mesh(_cluster(TC, cname))
    rpm = ref.process_mesh(ref_cl)
    assert pm.process_ids == rpm.process_ids and pm.placement == rpm.placement


@pytest.mark.parametrize("n,n_params", [(8, 10_000_000),
                                        (8, 30_000_000_000), (4, 354_000_000),
                                        (1, 1000), (16, 2_000_000_000)])
def test_plan_mesh_matches_the_reference(n, n_params):
    for kw in ({}, dict(tokens_per_batch=8192.0, batch_bytes=1e8)):
        ref = JPL.plan_mesh(n, n_params, **kw)
        port = TPL.plan_mesh(n, n_params, **kw)
        assert port.shape == ref.shape and port.dim_names == ref.dim_names
        assert port.process_ids == ref.process_ids


def test_estimate_step_time_matches_the_reference():
    cl_j, cl_t = JA.ClusterSpec(), TA.ClusterSpec()
    pb, flops = 4e8, 6 * 1e8 * 1e6
    for dp, sh, mp in ((8, 1, 1), (1, 1, 1), (1, 1, 8), (1, 8, 1),
                       (2, 2, 2)):
        for bb in (0.0, 1e9):
            want = JPL.estimate_step_time(dp, sh, mp, pb, pb * 4, flops, bb,
                                          cl_j)
            got = TPL.estimate_step_time(dp, sh, mp, pb, pb * 4, flops, bb,
                                         cl_t)
            assert got == pytest.approx(want, rel=1e-12)


def test_comp_cost_model_counts_a_matmul():
    m, k, n = 64, 128, 32
    res = TA.CompCostModel().analyze(lambda a, b: a @ b,
                                     np.zeros((m, k), np.float32),
                                     np.zeros((k, n), np.float32))
    assert res["flops"] == 2 * m * k * n
    assert res["bytes_accessed"] == 4 * (m * k + k * n + m * n)
    assert res["time"] == TA.CompCostModel().op_time(res["flops"],
                                                     res["bytes_accessed"])


# ------------------------------------------------------------ completion
def _tiny_gpts(seed=42):
    from paddle_tpu.text.gpt import GPTConfig as JG
    from paddle_tpu.text.gpt import GPTForCausalLM as JM
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM

    J.seed(seed)
    return (JM(JG(**GPT)), GPTForCausalLM(GPTConfig(**GPT), device="cpu"))


def _tiny_berts():
    import paddle_tpu_torch as T
    from paddle_tpu.text.bert import BertConfig as JB
    from paddle_tpu.text.bert import BertModel as JM
    from paddle_tpu_torch import _device
    from paddle_tpu_torch.text.bert import BertConfig, BertModel

    cfg = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
               intermediate_size=32, max_position_embeddings=16,
               hidden_dropout=0.0, attn_dropout=0.0)
    J.seed(1)
    prev = _device._CURRENT
    T.set_device("cpu")
    try:
        port = BertModel(BertConfig(**cfg))
    finally:
        _device._CURRENT = prev
    return JM(JB(**cfg)), port


def _mlps():
    import paddle_tpu_torch as T
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import _device, nn as tnn

    prev = _device._CURRENT
    T.set_device("cpu")
    try:
        port = tnn.Sequential(tnn.Linear(16, 64), tnn.ReLU(),
                              tnn.Linear(64, 32), tnn.GELU(),
                              tnn.Linear(32, 4))
    finally:
        _device._CURRENT = prev
    return jnn.Sequential(jnn.Linear(16, 64), jnn.ReLU(), jnn.Linear(64, 32),
                          jnn.GELU(), jnn.Linear(32, 4)), port


def _annotate(model, rules):
    for name, p in model.named_parameters():
        p._sharding_spec = None
        for suffix, spec in rules:
            if name.endswith(suffix):
                p._sharding_spec = spec


_GPT_RULES = [("qkv_proj.weight", (None, "mp")), ("fc1.weight", (None, "mp")),
              ("wte.weight", ("mp", None))]
_BERT_RULES = [("q_proj.weight", (None, "mp")), ("k_proj.weight", (None, "mp")),
               ("v_proj.weight", (None, "mp")),
               ("linear1.weight", (None, "mp")),
               ("word_embeddings.weight", ("mp", None))]
_MLP_RULES = [("0.weight", (None, "mp")), ("4.weight", ("mp", None))]


@pytest.mark.parametrize("which", ["gpt", "gpt_fc2", "bert", "mlp",
                                   "mlp_dp_input"])
def test_complete_param_specs_matches_the_reference(which):
    input_specs = None
    if which.startswith("gpt"):
        (jm, tm), rules = _tiny_gpts(), _GPT_RULES
        if which == "gpt_fc2":   # run in reverse: only the row weights
            rules = [("fc2.weight", ("mp", None)),
                     ("out_proj.weight", ("mp", None))]
        ids = np.random.RandomState(0).randint(0, 64, (2, 8))
        ins = ([ids.astype(np.int32)], [torch.as_tensor(ids)])
    elif which == "bert":
        (jm, tm), rules = _tiny_berts(), _BERT_RULES
        ids = np.random.RandomState(0).randint(0, 64, (2, 8))
        ins = ([ids.astype(np.int32)], [torch.as_tensor(ids)])
    else:
        (jm, tm), rules = _mlps(), _MLP_RULES
        x = np.zeros((8, 16), np.float32)
        ins = ([x], [torch.as_tensor(x)])
        if which == "mlp_dp_input":
            input_specs = [("dp", None)]
    _annotate(jm, rules)
    _annotate(tm, rules)
    want = {k: tuple(v) for k, v in JA.complete_param_specs(
        jm, ins[0], input_specs).items()}
    got = TA.complete_param_specs(tm, ins[1], input_specs)
    assert got == want
    assert {n: p._sharding_spec for n, p in tm.named_parameters()} == \
        {n: (None if p._sharding_spec is None else tuple(p._sharding_spec))
         for n, p in jm.named_parameters()}


def test_complete_matches_the_reference():
    """``tests/test_auto_parallel.py``'s ``f``: a row-split x times a
    column-split w."""
    mesh = JA.ProcessMesh(np.arange(8).reshape(2, 4),
                          dim_names=["dp", "mp"]).jax_mesh()

    def f(x, w):
        x = jax.lax.with_sharding_constraint(x, NamedSharding(mesh,
                                                              P("dp", None)))
        w = jax.lax.with_sharding_constraint(w, NamedSharding(mesh,
                                                              P(None, "mp")))
        return x @ w

    x, w = np.ones((16, 32), np.float32), np.ones((32, 64), np.float32)
    want = JA.complete(f, x, w)
    pm = TA.ProcessMesh(np.arange(8).reshape(2, 4), dim_names=["dp", "mp"])
    got = TA.complete(lambda a, b: a @ b, torch.as_tensor(x),
                      torch.as_tensor(w), mesh=pm,
                      in_shardings=[("dp", None), (None, "mp")])
    assert got["outputs"] == want["outputs"] == [("dp", "mp")]
    assert got["inputs"] == [("dp", None), (None, "mp")]
    assert got["output_shardings"][0] == TA.TensorDistAttr(pm, ["dp", "mp"])
    assert isinstance(got["compiled"], torch.fx.GraphModule)
    assert set(got) == set(want)


# ------------------------------------------------------------- four ranks
def _ref_gpt_params(seed=7):
    from paddle_tpu.text.gpt import GPTConfig as JG
    from paddle_tpu.text.gpt import GPTForCausalLM as JM

    J.seed(seed)
    return {k: np.asarray(v._value)
            for k, v in JM(JG(**GPT)).functional_state()[0].items()}


def _ref_mlp():
    from paddle_tpu import nn

    J.seed(42)
    return nn.Sequential(nn.Linear(16, 64), nn.ReLU(), nn.Linear(64, 4))


def _inputs():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 64, (GPT_BATCH, GPT["max_seq_len"])).astype(np.int64)
    rng = np.random.RandomState(0)
    xs = rng.randn(64, 16).astype(np.float32)
    ys = (xs[:, :4].argmax(-1)).astype(np.int64)
    return ids, xs, ys


def _plan_inputs():
    """The example's batch."""
    rng = np.random.RandomState(0)
    xs = rng.rand(8, FFN["d"]).astype(np.float32)
    ys = rng.randint(0, FFN["classes"], (8,)).astype(np.int64)
    return xs, ys


def _ref_ffn():
    from paddle_tpu import nn
    from paddle_tpu.distributed.fleet import (ColumnParallelLinear,
                                              RowParallelLinear)

    class FFNBlock(nn.Layer):
        def __init__(self):
            super().__init__()
            self.col = ColumnParallelLinear(FFN["d"], FFN["ffn"],
                                            gather_output=False)
            self.row = RowParallelLinear(FFN["ffn"], FFN["classes"],
                                         input_is_parallel=True)

        def forward(self, x):
            return self.row(nn.functional.relu(self.col(x)))

    J.seed(0)
    return FFNBlock()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest 8-device CPU mesh")
    from paddle_tpu_torch.distributed import spawn

    tmp = tmp_path_factory.mktemp("ap")
    ids, xs, ys = _inputs()
    mlp = {k: np.asarray(v.numpy()) for k, v in _ref_mlp().state_dict().items()}
    path = str(tmp / "in.npz")
    plan_xs, plan_ys = _plan_inputs()
    ffn = {k: np.asarray(v.numpy()) for k, v in _ref_ffn().state_dict().items()}
    np.savez(path, ids=ids, xs=xs, ys=ys, plan_xs=plan_xs, plan_ys=plan_ys,
             **{f"p:{k}": v for k, v in _ref_gpt_params().items()},
             **{f"m:{k}": v for k, v in mlp.items()},
             **{f"f:{k}": v for k, v in ffn.items()})
    return spawn(ap_rank, WORLD, args=(f"file://{tmp / 'rdv'}", path,
                                       str(tmp)), timeout_s=SPAWN_TIMEOUT_S)


def test_shard_tensor_and_reshard_round_trips(ranks):
    whole = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    for r, res in enumerate(ranks):
        out = res["reshard"]
        cx, cy = divmod(r, 2)
        np.testing.assert_array_equal(
            out["local"], whole[cx * 4:(cx + 1) * 4, cy * 8:(cy + 1) * 8])
        np.testing.assert_array_equal(out["moved"],
                                      whole[:, cx * 8:(cx + 1) * 8])
        np.testing.assert_array_equal(out["gathered"], whole)
        np.testing.assert_array_equal(out["rows"],
                                      whole[cy * 4:(cy + 1) * 4])
        # the permuted mesh: rank r at (r % 2, r // 2)
        px, py = r % 2, r // 2
        np.testing.assert_array_equal(
            out["perm_local"], whole[px * 4:(px + 1) * 4, py * 8:(py + 1) * 8])
        np.testing.assert_array_equal(out["perm_gathered"], whole)
        assert out["perm_groups"] == {"x": [2 * py, 2 * py + 1],
                                      "y": [px, px + 2]}
        np.testing.assert_array_equal(out["a2a"],
                                      whole[:, cx * 8:(cx + 1) * 8])
        if r >= 2:
            k = r - 2
            np.testing.assert_array_equal(out["across"],
                                          whole[:, k * 8:(k + 1) * 8])
        else:
            assert out["across"] is None


def test_resharder_log_kinds(ranks):
    for res in ranks:
        assert res["reshard"]["log"] == ["all_gather+slice", "all_gather",
                                         "slice", "noop", "all_to_all"]
        assert res["reshard"]["across_log"] == [
            "all_gather+send_recv+slice"]


def _ref_engine(annotate):
    from paddle_tpu import nn
    from paddle_tpu.distributed.fleet.meta_parallel import apply_megatron_specs
    from paddle_tpu.text.gpt import GPTConfig as JG
    from paddle_tpu.text.gpt import GPTForCausalLM as JM

    ids = _inputs()[0].astype(np.int32)
    pm = JA.ProcessMesh(np.arange(4).reshape(2, 2), dim_names=["dp", "mp"])

    def lm_loss(logits, labels):
        return nn.functional.cross_entropy(
            logits.reshape([-1, 64]), labels.reshape([-1]).astype("int64"))

    J.seed(7)
    m = JM(JG(**GPT))
    if annotate == "partial":
        _annotate(m, _GPT_RULES)
    else:
        apply_megatron_specs(m)
    opt = J.optimizer.SGD(GPT_LR, parameters=m.parameters())
    eng = JA.Engine(model=m, loss=lm_loss, optimizer=opt, process_mesh=pm)
    eng.prepare(inputs_spec=[jax.ShapeDtypeStruct(ids.shape, np.int32)])
    return eng.fit([(ids, ids)] * GPT_STEPS, epochs=1, log_freq=1)["loss"], {
        n: tuple(p._sharding_spec) for n, p in m.named_parameters()
        if p._sharding_spec is not None}


def test_engine_matches_the_reference_engine(ranks):
    """The reference's done-criterion, on four ranks: the partly annotated
    and completed run and the ``apply_megatron_specs`` run give the same
    losses, each the reference Engine's on its 2 x 2 mesh."""
    for annotate in ("partial", "megatron"):
        want, specs = _ref_engine(annotate)
        for res in ranks:
            got = res[annotate]
            assert got["losses"] == pytest.approx(want, rel=LOSS_RTOL)
            assert got["specs"] == specs
    for res in ranks:
        assert res["partial"]["losses"] == pytest.approx(
            res["megatron"]["losses"], rel=LOSS_RTOL)
    part, meg = ranks[0]["partial"], ranks[0]["megatron"]
    assert part["counts"] == {"whole": 21, "vocab": 1, "column": 4, "row": 2}
    assert meg["counts"] == {"whole": 15, "vocab": 1, "column": 8, "row": 4}
    assert part["layout"]["gpt.blocks.0.attn.qkv_proj.weight"] == "whole"
    assert meg["layout"]["gpt.blocks.0.attn.qkv_proj.weight"] == "column"


def test_engine_fit_evaluate_predict_save_load(ranks):
    from paddle_tpu import nn

    model = _ref_mlp()
    opt = J.optimizer.Adam(learning_rate=MLP_LR, parameters=model.parameters())
    eng = JA.Engine(model=model, loss=nn.CrossEntropyLoss(), optimizer=opt,
                    metrics=J.metric.Accuracy())
    _, xs, ys = _inputs()
    batches = [(xs[i:i + 16], ys[i:i + 16]) for i in range(0, 64, 16)]
    hist = eng.fit(batches, epochs=MLP_EPOCHS, log_freq=MLP_LOG_FREQ)
    res = eng.evaluate(batches)
    pred = eng.predict([(xs[:16],)])[0][0]
    for out in ranks:
        got = out["mlp"]
        assert got["losses"] == pytest.approx(hist["loss"], rel=1e-4)
        assert got["losses"][-1] < got["losses"][0] * 0.8
        assert got["eval"]["loss"] == pytest.approx(res["loss"], rel=1e-4)
        assert got["eval"]["acc"] == res["acc"]
        np.testing.assert_allclose(got["pred"], pred, rtol=1e-4, atol=1e-5)
        assert got["mesh"] == JA.plan_mesh(
            WORLD, sum(int(np.prod(p.shape)) for p in model.parameters())
        ).shape and got["saved"]
        assert got["eval_loaded"] == got["eval"]


def test_auto_parallel_plan_example_workflow(ranks):
    """``examples/auto_parallel_plan.py`` at four ranks: the plan of the
    wide FFN, its placement and the six losses of training on the planned
    mesh, against the reference's on four of its devices; the block with
    its output gathered and its row input split takes the same steps."""
    from paddle_tpu import nn
    from paddle_tpu.core import rng as rng_mod
    from paddle_tpu.distributed.fleet.hybrid_train import build_hybrid_step

    cluster = JA.cpu_test_cluster(WORLD)
    plan = JA.plan_parallel(WORLD, JA.ModelDesc(**PLAN_DESC), cluster)
    model = _ref_ffn()
    opt = J.optimizer.Adam(PLAN_LR, parameters=model.parameters())
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(
        plan.dp, plan.sharding, plan.mp), ("dp", "sharding", "mp"))
    init_fn, step_fn, shard_batch = build_hybrid_step(
        model, opt, nn.CrossEntropyLoss(), mesh)
    state = init_fn()
    xs, ys = _plan_inputs()
    want = []
    for _ in range(PLAN_STEPS):
        loss, state = step_fn(state, rng_mod.next_rng_key(), PLAN_LR,
                              shard_batch([xs]), shard_batch([ys]))
        want.append(float(loss))
    placement = plan.process_mesh(cluster).placement
    for res in ranks:
        got = res["plan"]
        assert got["plan"] == plan.axis_sizes == {"dp": 1, "sp": 1,
                                                   "sharding": 1, "mp": 4}
        assert got["t_comm"] == pytest.approx(plan.t_comm, rel=1e-12)
        assert got["placement"] == placement
        assert got["losses"] == pytest.approx(want, rel=LOSS_RTOL)
        assert got["gathered"] == pytest.approx(want, rel=LOSS_RTOL)
        assert got["layout"] == {"col.weight": "column", "col.bias": "column",
                                 "row.weight": "row", "row.bias": "whole"}
        assert got["layout_gathered"] == got["layout"]
