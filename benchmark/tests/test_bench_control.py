"""The control: the reference put in the program's place at the precision
below the configuration's (scaled fp8 products for bf16 ones; bfloat16
state for float32) reads ``correct`` false against the cell's limits.
Here at a tiny size on the CPU; ``benchmark/calibrate.py`` reads it on
the card at the cell's own size."""
import pytest
import torch

from benchmark import calibrate, harness, loops
from benchmark.yardstick import compare

from test_bench_faults import TINY


@pytest.mark.parametrize("workload", list(TINY))
def test_control_reads_incorrect(workload, cpu_kernels):
    torch.set_num_threads(4)
    man = harness.manifest()
    cell = harness.cell_of(man, workload)
    config = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
    traffic = dict(harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json"), envs=TINY[workload])
    limits = harness.load_json(harness.HERE / "limits" / f"{workload}.json")["numbers"]
    loop = loops.loop_class(traffic["loop"])(config, traffic, 4242, "cpu")
    loop.setup()
    for _ in range(3):
        loop.call()
    loop.free()
    sound = loop.check()
    control = loop.check(rounding=calibrate.CONTROLS[loop.precision])
    assert compare.judge(control, limits)[0] is False
    assert max(control[k] / limits[k]["limit"] for k in control) > max(sound[k] / limits[k]["limit"] for k in sound)

