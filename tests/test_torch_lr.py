"""The port's learning-rate schedulers (``paddle_tpu_torch.optimizer.lr``)
against the JAX package's ``paddle_tpu.optimizer.lr``: all sixteen (the
base ``LRScheduler`` and its fifteen schedules), 60 steps each.

They are plain Python on both sides, so ``last_lr`` must be equal float
for float at every step, and ``state_dict`` must equal the reference's
and round-trip into a fresh scheduler.
"""
import pytest

from paddle_tpu.optimizer import lr as J
from paddle_tpu_torch.optimizer import lr as T

STEPS = 60
#: name -> a builder over either module, with arguments that reach every
#: branch of the schedule within 60 steps
CASES = {
    "NoamDecay": lambda m: m.NoamDecay(512, 10, learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([10, 30],
                                                 [0.1, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, 0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, 0.1),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, 20, 0.01, 2.0),
    "PolynomialDecay-cycle": lambda m: m.PolynomialDecay(0.5, 20, 0.01, 1.5,
                                                         cycle=True),
    "LinearWarmup-cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(1.5e-4, 50), 10, 0.0, 1.5e-4),
    "LinearWarmup-float": lambda m: m.LinearWarmup(0.1, 10, 0.001, 0.1),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, 0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [10, 25, 40], 0.5),
    "StepDecay": lambda m: m.StepDecay(0.5, 7, 0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.5, 20, 0.01),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.5, factor=0.5,
                                                   patience=2, cooldown=1),
    "ReduceOnPlateau-max-abs": lambda m: m.ReduceOnPlateau(
        0.5, mode="max", patience=1, threshold=0.01, threshold_mode="abs",
        min_lr=0.05),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, 50),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, 5, mode="triangular2"),
    "CyclicLR-asymmetric": lambda m: m.CyclicLR(0.01, 0.1, 4,
                                                step_size_down=9),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.5, lambda e: 0.97 if e % 2 else 0.99),
}


def _metric(i: int) -> float:
    """A loss that falls, then stalls and wobbles (for ReduceOnPlateau)."""
    return 1.0 / (1 + i) if i < 15 else 0.06 + 0.001 * (i % 3)


def _step(sched, i: int) -> None:
    if isinstance(sched, (J.ReduceOnPlateau, T.ReduceOnPlateau)):
        sched.step(_metric(i))
    else:
        sched.step()


@pytest.mark.parametrize("name", CASES)
def test_last_lr_equals_reference_float_for_float(name):
    want, got = CASES[name](J), CASES[name](T)
    assert got() == want() and type(got()) is type(want())
    for i in range(STEPS):
        _step(want, i)
        _step(got, i)
        assert got.last_lr == want.last_lr, (name, i)
        assert got.last_epoch == want.last_epoch
    assert got.state_dict() == want.state_dict()


@pytest.mark.parametrize("name", CASES)
def test_state_dict_round_trips(name):
    sched = CASES[name](T)
    for i in range(STEPS // 2):
        _step(sched, i)
    fresh = CASES[name](T)
    fresh.set_state_dict(sched.state_dict())
    assert fresh.state_dict() == sched.state_dict()
    assert fresh() == sched()
    other = CASES[name](T)
    other.set_dict(sched.state_dict())  # the reference's alias
    assert other.last_epoch == sched.last_epoch


def test_base_scheduler_has_no_rate():
    for m in (J, T):
        with pytest.raises(NotImplementedError):
            m.LRScheduler(0.1)
    assert set(T.__all__) == {n for n in dir(J) if isinstance(
        getattr(J, n), type) and issubclass(getattr(J, n), J.LRScheduler)}
