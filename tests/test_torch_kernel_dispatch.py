"""Each kernel's ``ops.py`` is the one place that picks the kernel or the plain
version: off the card the op gives the plain version's result and launches
nothing, and the kernel's own entry raises there."""

import numpy as np
import pytest
import torch

from repro.core import get_instance, synthetic_trace
from repro.engine import BID_LIMITED_SCHEMES
from repro.engine import Scenario as RefScenario

from repro_torch.engine import Scenario
from repro_torch.engine.batch import grid_and_tables
from repro_torch.kernels.ckpt_codec import kernel as codec_kernel, ops as codec_ops, ref as codec_ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel, ops as flash_ops, ref as flash_ref
from repro_torch.kernels.mamba_inputs import kernel as inputs_kernel, ops as inputs_ops, ref as inputs_ref
from repro_torch.kernels.rglru_scan import kernel as rglru_kernel, ops as rglru_ops, ref as rglru_ref
from repro_torch.kernels.spot_sweep import kernel as sweep_kernel, ops as sweep_ops, ref as sweep_ref
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel, ops as ssm_ops, ref as ssm_ref


def randn(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def scan_case(kernel, ops, ref, name):
    if name == "ssm_scan":
        args = (-randn(1, 8, 4, 4).abs(), randn(1, 8, 4, 4, seed=1), randn(1, 8, 4, seed=2))
    else:
        args = (-randn(1, 8, 4).abs(), randn(1, 8, 4, seed=1))
    fn = getattr(ops, name), getattr(ref, name), getattr(kernel, name)
    return kernel, (lambda: fn[0](*args)), (lambda: fn[1](*args)), (lambda: fn[2](*args))


def flash_case():
    q, k, v = randn(1, 16, 2, 16), randn(1, 16, 1, 16, seed=1), randn(1, 16, 1, 16, seed=2)
    kw = dict(causal=True, q_block=8, kv_block=8)
    return (flash_kernel, lambda: flash_ops.flash_attention(q, k, v, **kw),
            lambda: flash_ref.block_attention(q, k, v, **kw), lambda: flash_kernel.flash_attention(q, k, v, **kw))


def codec_case():
    x = randn(3000)
    return (codec_kernel, lambda: codec_ops.quantize(x)[:2], lambda: codec_ref.quantize(x)[:2],
            lambda: codec_kernel.quantize(x))


def mamba_inputs_case():
    proj = randn(1, 8, 13, seed=4).bfloat16()
    args = (randn(1, 8, 6).bfloat16(), randn(6, seed=1).bfloat16(), randn(6, 4, seed=2),
            randn(1, 8, 6, seed=3).bfloat16(), proj[..., 5:9])
    return (inputs_kernel, lambda: inputs_ops.mamba_inputs(*args), lambda: inputs_ref.mamba_inputs(*args),
            lambda: inputs_kernel.mamba_inputs(*args))


def sweep_case():
    """The op's per-scheme fields against the plain sweep's raw outputs on
    the same grid (cost is billed on the host from the records either way)."""
    ref_sc = RefScenario.from_trace(synthetic_trace(get_instance("m1.xlarge"), 2, seed=5), 6 * 3600.0,
                                    bids=[0.34, 0.36], schemes=BID_LIMITED_SCHEMES)
    sc = Scenario.from_reference(ref_sc.canonical(), [(t.times, t.prices) for t in ref_sc.traces])
    grid, tables = grid_and_tables(sc, sc.materialize(), True)
    arrs = sweep_ops.device_arrays(grid, torch.device("cpu"), True, True, sc.params.t_r, tables)
    args = (sc.schemes, arrs["A"], arrs["B"], arrs["valid"], arrs["horizon"], sweep_ops.sweep_consts(sc, tables),
            arrs["ptr0"], arrs["edges"], arrs["tables"])
    fields = ("completion_time", "n_checkpoints", "work_lost_s", "n_kills")

    def by_op():
        outs, info = sweep_ops.spot_sweep_grid(sc.schemes, grid, sc, tables, device="cpu")
        assert info["impl"] == "plain"
        return tuple(torch.from_numpy(np.asarray(outs[s][f])) for s in sc.schemes for f in fields)

    def by_ref():
        comp, ckpt, lost, kills = sweep_ref.sweep_plain(*args)[1:5]
        return tuple(x[si] for si in range(len(sc.schemes)) for x in (comp, ckpt, lost, kills))

    return sweep_kernel, by_op, by_ref, lambda: sweep_kernel.spot_sweep(*args)


CASES = {
    "ssm_scan": lambda: scan_case(ssm_kernel, ssm_ops, ssm_ref, "ssm_scan"),
    "rglru_scan": lambda: scan_case(rglru_kernel, rglru_ops, rglru_ref, "rglru_scan"),
    "flash_attention": flash_case,
    "mamba_inputs": mamba_inputs_case,
    "quantize": codec_case,
    "spot_sweep": sweep_case,
}


@pytest.mark.parametrize("name", list(CASES))
def test_the_op_runs_the_plain_version_off_the_card_and_the_kernel_refuses(name):
    kernel, by_op, by_ref, by_kernel = CASES[name]()
    before = kernel.launches
    got, want = by_op(), by_ref()
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    with pytest.raises(ValueError, match="runs on cuda"):
        by_kernel()
    assert kernel.launches == before
