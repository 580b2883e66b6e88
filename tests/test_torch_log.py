"""imagestitch_tpu_torch's logging and stage timer (`utils/log.py`) against
`imagestitch_tpu.utils.log` on the CPU: `StageTimer` sums the same stage
names as the JAX package's, takes `sync=` and tensors, and runs each stage
inside a `record_function` range of its name, so a CPU `torch.profiler`
trace holds one range per stage entered, nested stages included, and
stages entered from several threads at once keep apart; `get_logger`
adds its handler once."""

import threading

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from imagestitch_tpu.utils import log as jlog  # noqa: E402
from imagestitch_tpu_torch.utils import StageTimer, get_logger  # noqa: E402


def _ranges(prof, names):
    """How many CPU events of each of `names` the trace holds."""
    evs = [e.name for e in prof.events()]
    return {n: evs.count(n) for n in names}


@pytest.mark.parametrize("sync", [True, False])
def test_stage_names_are_profiler_ranges(sync):
    timer = StageTimer("cpu", sync=sync)
    jtimer = jlog.StageTimer(sync=sync)
    x = torch.arange(6.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for t, arr in ((timer, x), (jtimer, jnp.arange(6.0))):
            with t.stage("detect", arr):
                pass
            with t.stage("warp"):
                with t.stage("warp_inner", arr, arr):
                    pass
            with t.stage("detect"):
                pass
    names = ("detect", "warp", "warp_inner")
    assert _ranges(prof, names) == {"detect": 2, "warp": 1, "warp_inner": 1}
    assert sorted(timer.summary()) == sorted(jtimer.summary()) == \
        sorted(names)
    assert all(ms >= 0.0 for ms in timer.summary().values())


def test_stage_ranges_beside_threads():
    """Stages entered from four threads at once (as the mesh runs shards)
    while the main thread's own stages are traced: every thread's timer
    gets its own stages, nothing raises, and the trace holds the main
    thread's ranges once each (a CPU trace records the thread that
    started it)."""
    timers = [StageTimer() for _ in range(4)]
    main = StageTimer(sync=False)
    barrier = threading.Barrier(5, timeout=30)
    errors = []

    def shard(i):
        try:
            with timers[i].stage(f"shard{i}", torch.ones(3)):
                barrier.wait()
                with timers[i].stage("inner"):
                    torch.ones(8).sum()
        except Exception as e:     # reported below, in the main thread
            errors.append(e)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        threads = [threading.Thread(target=shard, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        with main.stage("main"):
            barrier.wait()
            with main.stage("inner"):
                torch.ones(8).sum()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert _ranges(prof, ["main", "inner"]) == {"main": 1, "inner": 1}
    assert sorted(main.summary()) == ["inner", "main"]
    assert [sorted(t.summary()) for t in timers] == \
        [sorted([f"shard{i}", "inner"]) for i in range(4)]


def test_get_logger_adds_one_handler():
    a = get_logger()
    b = get_logger()
    assert a is b and a.name == "imagestitch_tpu_torch"
    assert len(a.handlers) == 1
    other = get_logger("imagestitch_tpu_torch.test")
    assert len(get_logger("imagestitch_tpu_torch.test").handlers) == 1
    assert other is not a
