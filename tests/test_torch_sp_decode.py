"""Sequence-parallel decode in the port against the JAX package's plain decode, on the CPU.

Eight ranks (``repro_torch.parallel.ranks.run_ranks``: processes joined in a
gloo group through a file store) form a 2 (data) x 4 (model) mesh with
``kv_seq`` on ``model``, as ``tests/parallel/test_sp_decode.py`` does in JAX:
internlm2-20b's smoke config in float32 with the JAX package's own init
carried across (``from_jax``), a batch of 2 prompts of 9 tokens, the first
prefilled into a cache of 16 slots (4 a rank), then 8 decode steps, so the
appended positions cross three ranks' slices.  The same on a 2 (pod) x 2
(data) x 2 (model) mesh, where the batch of 2 splits over ``pod`` only and
is replicated along ``data``; and, on the 2 x 4 mesh, whisper's decoder (its
self-attention caches sliced, the cross-attention caches whole) and
recurrentgemma (the window-sized caches are circular and stay whole, beside
the recurrent states).  Each rank's rows of every step's logits match JAX's
plain (no mesh) decode, and every cache entry it holds matches JAX's at its
rows and, for a sequence slice, its positions.

Tolerance: 1e-4 on logits and caches in float32 (the JAX test's 3e-2 is for
bf16).  The two sides differ in the order of the attention's sums (partial
softmaxes merged, against one) and of the matmuls, ~1e-6 here; 1e-4 is the
float32 tolerance the port's model tests hold the plain decode to.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import transformer as JT
from repro_torch.configs import get_smoke_config
from repro_torch.parallel.ranks import run_ranks

import torch_ranks

MESHES = {"data_model": ((2, 4), ("data", "model")), "pod_data_model": ((2, 2, 2), ("pod", "data", "model"))}
CASES = [("internlm2-20b", "data_model"), ("internlm2-20b", "pod_data_model"), ("whisper-large-v3", "data_model"),
         ("recurrentgemma-9b", "data_model")]
MAX_LEN, STEPS, BLOCK = 16, 8, 8
TOL = 1e-4


def f32(x) -> np.ndarray:
    return x.float().numpy() if hasattr(x, "float") else np.asarray(x, np.float32)


@functools.cache
def jax_decode(arch):
    """The JAX package's float32 init, the batch (numpy, from a seed), and its
    plain decode: every step's logits and the final cache."""
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), dtype="float32")
    params = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, STEPS + 1)).astype(np.int32)}
    if jcfg.family == "encdec":
        batch["frames"] = rng.standard_normal((2, jcfg.encoder_positions, jcfg.d_model)).astype(np.float32)
    first = {k: jnp.asarray(v[:, :1] if k == "tokens" else v) for k, v in batch.items()}
    _, cache = JT.prefill(jcfg, params, first, MAX_LEN, q_block=BLOCK, kv_block=BLOCK)
    step = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, t, c))
    logits = []
    for i in range(1, STEPS + 1):
        out, cache = step(params, jnp.asarray(batch["tokens"][:, i:i + 1]), cache)
        logits.append(np.asarray(out))
    return params, batch, np.concatenate(logits, axis=1), jax.tree.map(np.asarray, cache)


def check_cache(got, want, rows, rank, tp, what) -> int:
    """Every entry of a layer's cache against JAX's at this rank's rows (and
    positions, for a sequence slice); returns how many slices it held."""
    assert set(got) - {"seq_len"} == set(want), what
    slices = 0
    for name, value in got.items():
        if isinstance(value, dict):
            slices += check_cache(value, want[name], rows, rank, tp, f"{what} {name}")
        elif name == "len":
            assert value == int(want[name]), what
        elif name != "seq_len":
            ref = want[name][rows]
            if "seq_len" in got:
                assert got["seq_len"] == MAX_LEN and value.shape[1] == MAX_LEN // tp, what
                ref = ref[:, rank * value.shape[1]:(rank + 1) * value.shape[1]]
                slices += 1
            np.testing.assert_allclose(f32(value), ref, atol=TOL, rtol=TOL, err_msg=f"{what} {name}")
    return slices


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sp_decode_matches_jax_plain_decode(tmp_path, arch, mesh):
    params, batch, want_logits, want_cache = jax_decode(arch)
    shape, axes = MESHES[mesh]
    tp, n = shape[-1], int(np.prod(shape))
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    torch.save({"cfg": cfg, "params": params, "batch": batch}, tmp_path / "inputs.pt")
    ranks = run_ranks(torch_ranks.sp_decode_rank, n, tmp_path / "inputs.pt", shape, axes, MAX_LEN, BLOCK)
    sliced = {"internlm2-20b": 4, "whisper-large-v3": 4, "recurrentgemma-9b": 0}[arch]  # k and v of 2 layers
    for r, out in enumerate(ranks):
        lo, hi = out["rows"]
        assert (lo, hi) == (r // (n // shape[0]), r // (n // shape[0]) + 1)  # the first axis splits the batch of 2
        assert out["model_rank"] == r % tp
        np.testing.assert_allclose(f32(out["logits"]), want_logits[lo:hi], atol=TOL, rtol=TOL,
                                   err_msg=f"rank {r} logits")
        held = sum(check_cache(lc, jlc, slice(lo, hi), r % tp, tp, f"rank {r} layer {i}")
                   for i, (lc, jlc) in enumerate(zip(out["cache"], want_cache["layers"], strict=True)))
        assert held == sliced
    # the decode wrote positions 1..8, past the first rank's slice
    assert STEPS >= MAX_LEN // tp
