"""`correct` on the CPU at a small size: a sound run passes, and the
control and the planted faults of `control.py` fail the cell's limits."""
import pytest

from perfbench import harness
from perfbench._testing import INFER, TRAIN, run_small


@pytest.mark.parametrize("workload", TRAIN + INFER)
def test_sound_run_is_correct(workload):
    out = run_small(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    names = {m["name"] for m in harness.load_benchmark()["end_to_end"]
             if workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) == names
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload", TRAIN + INFER)
def test_control_and_faults_fail_the_limits(workload):
    """The control (the reference in TF32 in the program's place) and the
    planted faults of `control.readings` fail the cell's limits, and the
    program passes them, on a small replica."""
    from perfbench import check, control
    from perfbench._testing import SEED, nodes
    ctx = control.context(workload, device="cpu", backend="torch",
                          num_nodes=nodes(workload, control=True),
                          cache_dir=None)
    (row,) = control.readings(ctx, [SEED], {SEED}, emit=lambda s: None)
    assert check.judge(row["program"], ctx.limits)[0], row
    assert not check.judge(row["control"], ctx.limits)[0], row
    for name, numbers in row["faults"].items():
        assert not check.judge(numbers, ctx.limits)[0], (name, row)
