"""The fleet executor of the port
(``paddle_tpu_torch.distributed.fleet_executor``) against the JAX
package's: the counterparts of ``tests/test_fleet_executor.py``'s seven
tests (the same graphs, the same results; the jitted stages become torch
stages), tensor payloads over the TCP bus, and a two-stage pipeline of
the reference test's tiny GPT (the reference's weights carried across by
``text.convert.state_dict_from_jax``) whose logits equal the reference
model's within 1e-5.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.distributed import fleet_executor as JF
from paddle_tpu_torch.distributed import fleet_executor as TF

GPT = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
           max_seq_len=8, dropout=0.0)
LOGITS_TOL = dict(rtol=1e-5, atol=1e-5)


def _chain(F, n_micro, fns, buffer_size=2, ranks=None):
    """source -> compute... -> sink chain (the reference test's)."""
    nodes = [F.TaskNode(0, rank=0, max_run_times=n_micro, type="Source",
                        run_fn=lambda i: i)]
    for k, fn in enumerate(fns, start=1):
        r = ranks[k] if ranks else 0
        nodes.append(F.TaskNode(k, rank=r, max_run_times=n_micro,
                                type="Compute", run_fn=fn))
    nodes.append(F.TaskNode(len(fns) + 1, rank=ranks[-1] if ranks else 0,
                            max_run_times=n_micro, type="Sink"))
    for a, b in zip(nodes, nodes[1:]):
        a.add_downstream_task(b.task_id, buffer_size)
        b.add_upstream_task(a.task_id, buffer_size)
    return nodes


@pytest.mark.parametrize("F", [JF, TF], ids=["reference", "port"])
def test_source_compute_sink_chain(F):
    nodes = _chain(F, 6, [lambda x: x * 2, lambda x: x + 1])
    assert F.FleetExecutor(nodes).run() == [i * 2 + 1 for i in range(6)]


@pytest.mark.parametrize("F", [JF, TF], ids=["reference", "port"])
def test_credit_backpressure_limits_inflight(F):
    inflight, peak = [0], [0]

    def slow_stage(x):
        inflight[0] += 1
        peak[0] = max(peak[0], inflight[0])
        time.sleep(0.005)
        inflight[0] -= 1
        return x

    nodes = _chain(F, 8, [slow_stage], buffer_size=1)
    assert F.FleetExecutor(nodes).run() == list(range(8))
    assert peak[0] <= 1


@pytest.mark.parametrize("F", [JF, TF], ids=["reference", "port"])
def test_multi_carrier_cross_rank(F):
    nodes = _chain(F, 5, [lambda x: x + 10, lambda x: x * 3],
                   ranks={1: 0, 2: 1, -1: 1})
    exe = F.FleetExecutor(nodes)
    assert exe.run() == [(i + 10) * 3 for i in range(5)]
    assert len(exe.carriers) == 2


@pytest.mark.parametrize("F", [JF, TF], ids=["reference", "port"])
def test_amplifier_gradient_accumulation(F):
    acc = []

    def accumulate(x):
        acc.append(x)
        return sum(acc)

    src = F.TaskNode(0, max_run_times=6, type="Source", run_fn=lambda i: 1)
    amp = F.TaskNode(1, max_run_times=6, type="Amplifier",
                     run_fn=accumulate, send_down_per_steps=3)
    sink = F.TaskNode(2, max_run_times=2, type="Sink")
    src.add_downstream_task(1, 8)
    amp.add_upstream_task(0, 8)
    amp.add_downstream_task(2, 8)
    sink.add_upstream_task(1, 8)
    exe = F.FleetExecutor([src, amp, sink])
    assert isinstance(exe.carriers[0]._interceptors[1],
                      F.AmplifierInterceptor)
    assert exe.run() == [3, 6]


@pytest.mark.parametrize("F", [JF, TF], ids=["reference", "port"])
def test_amplifier_run_per_steps_fanout(F):
    seen = []

    def record(x):
        seen.append(x)
        return x

    src = F.TaskNode(0, max_run_times=3, type="Source", run_fn=lambda i: i)
    amp = F.TaskNode(1, max_run_times=6, type="Amplifier", run_fn=record,
                     run_per_steps=2)
    sink = F.TaskNode(2, max_run_times=6, type="Sink")
    src.add_downstream_task(1, 4)
    amp.add_upstream_task(0, 4)
    amp.add_downstream_task(2, 8)
    sink.add_upstream_task(1, 8)
    assert F.FleetExecutor([src, amp, sink]).run() == [0, 0, 1, 1, 2, 2]
    assert seen == [0, 0, 1, 1, 2, 2]


def test_pipeline_with_torch_stages():
    """The reference's jitted two-stage pipeline; here each stage is a
    torch function on the carrier's device (the CPU)."""
    w1 = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    w2 = np.random.RandomState(1).randn(8, 2).astype(np.float32)
    batches = [np.random.RandomState(i).randn(3, 4).astype("float32")
               for i in range(4)]
    tw1, tw2 = torch.as_tensor(w1), torch.as_tensor(w2)
    nodes = _chain(TF, 4, [lambda x: torch.tanh(x @ tw1),
                           lambda h: h @ tw2])
    nodes[0].run_fn = lambda i: torch.as_tensor(batches[i])
    results = TF.FleetExecutor(nodes, devices="cpu").run()
    for i, out in enumerate(results):
        np.testing.assert_allclose(out.numpy(),
                                   np.tanh(batches[i] @ w1) @ w2, rtol=1e-5)


def _over_tcp(F, n_micro, fn, feed=None):
    """Two executors (disjoint local ranks) over the TCP bus: rank 0 the
    source, rank 1 the stage and the sink."""
    def spec():
        nodes = _chain(F, n_micro, [fn], ranks={1: 1, -1: 1})
        if feed is not None:
            nodes[0].run_fn = feed
        return nodes

    bus_a, bus_b = F.MessageBus(), F.MessageBus()
    exe_a = F.FleetExecutor(spec(), bus=bus_a, local_ranks={0})
    exe_b = F.FleetExecutor(spec(), bus=bus_b, local_ranks={1})
    srv_a, port_a = bus_a.serve()
    srv_b, port_b = bus_b.serve()
    bus_a.register_remote(1, f"127.0.0.1:{port_b}")
    bus_b.register_remote(0, f"127.0.0.1:{port_a}")
    results = {}
    tb = threading.Thread(target=lambda: results.update(b=exe_b.run(
        timeout=30)))
    tb.start()
    exe_a.run(timeout=30)
    tb.join(timeout=35)
    srv_a.shutdown()
    srv_b.shutdown()
    bus_a.close()
    bus_b.close()
    return results["b"]


@pytest.mark.parametrize("F", [JF, TF], ids=["reference", "port"])
def test_remote_message_bus_over_tcp(F, monkeypatch):
    monkeypatch.setenv("PADDLE_PS_BIND_HOST", "127.0.0.1")
    assert _over_tcp(F, 4, lambda x: x + 100) == [i + 100 for i in range(4)]


def test_tensor_payloads_over_tcp(monkeypatch):
    """Tensors cross the wire as host tensors, bit for bit."""
    monkeypatch.setenv("PADDLE_PS_BIND_HOST", "127.0.0.1")
    xs = [torch.randn(3, 5, generator=torch.Generator().manual_seed(i))
          .to(torch.bfloat16) for i in range(3)]
    got = _over_tcp(TF, 3, lambda x: x * 2, feed=lambda i: xs[i])
    for a, b in zip(got, xs):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b * 2)


# -------------------------------------------------- the GPT in two stages
def gpt_stages(model, split):
    """``model`` (the port's GPT) as two stage functions: the embeddings
    and blocks ``[0, split)``; blocks ``[split, L)``, the final
    LayerNorm and the tied head."""
    g = model.gpt

    def first(ids):
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        x = g.drop(g.wte(ids) + g.wpe(pos))
        for blk in g.blocks[:split]:
            x = blk(x)
        return x

    def second(x):
        for blk in g.blocks[split:]:
            x = blk(x)
        return torch.nn.functional.linear(g.ln_f(x), g.wte.weight)

    return first, second


def test_gpt_two_stage_pipeline_matches_the_reference():
    from paddle_tpu.text.gpt import GPTConfig as JG
    from paddle_tpu.text.gpt import GPTForCausalLM as JM
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.text.convert import state_dict_from_jax

    J.seed(3)
    ref = JM(JG(**GPT))
    params = {k: np.asarray(v._value)
              for k, v in ref.functional_state()[0].items()}
    cfg = GPTConfig(**GPT)
    port = GPTForCausalLM(cfg, device="cpu")
    missing, unexpected = port.set_state_dict(state_dict_from_jax(params,
                                                                  cfg))
    assert missing == [] and unexpected == []
    micro = [np.random.RandomState(i).randint(0, 64, (2, 8)) for i in range(4)]
    first, second = gpt_stages(port, 1)
    nodes = _chain(TF, len(micro), [first, second], ranks={1: 0, 2: 1, -1: 1})
    nodes[0].run_fn = lambda i: torch.as_tensor(micro[i])
    with torch.no_grad():   # the carriers' threads take the caller's mode
        got = TF.FleetExecutor(nodes, devices="cpu").run()
    assert not any(t.requires_grad for t in got)
    for ids, out in zip(micro, got):
        want = np.asarray(ref(J.to_tensor(ids.astype(np.int32)))._value)
        np.testing.assert_allclose(out.numpy(), want, **LOGITS_TOL)
