"""``chip_smoke.py``'s host-side parts, on the CPU: the bounds it computes, the
cases it covers, and its refusal to run without a GPU."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize(
    "sq, sk, causal, window, q_offset",
    [(7, 7, True, 0, 0), (7, 7, False, 0, 0), (20, 20, True, 5, 0), (5, 30, True, 0, 25), (6, 30, True, 4, 20),
     (9, 12, False, 3, 0), (4, 3, True, 0, 10)],
)
def test_visible_pairs_counts_the_mask(smoke, sq, sk, causal, window, q_offset):
    q = np.arange(sq)[:, None] + q_offset
    k = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), dtype=bool)
    if causal:
        mask &= k <= q
    if window:
        mask &= k > q - window
    assert smoke.visible_pairs(sq, sk, causal, window, q_offset) == int(mask.sum())


def test_bounds_at_the_served_shapes(smoke):
    meta = {"device": "meta", "dtype": torch.bfloat16}
    glm = smoke.attention_bound(torch.empty((2, 4096, 32, 128), **meta), torch.empty((2, 4096, 2, 128), **meta),
                                True, 0, 0)
    gemma = smoke.attention_bound(torch.empty((2, 4096, 16, 256), **meta), torch.empty((2, 4096, 1, 256), **meta),
                                  True, 2048, 0)
    assert glm[1] == gemma[1] == "operations"
    assert glm[0] == pytest.approx(4 * 128 * 4096 * 4097 / 2 * 2 * 32 / 989e9)  # ~0.278 ms
    assert gemma[0] == pytest.approx(4 * 256 * (2048 * 2049 / 2 + 2048 * 2048) * 2 * 16 / 989e9)  # ~0.208 ms
    f32 = {"device": "meta", "dtype": torch.float32}
    rglru = smoke.scan_bound("rglru_scan", (torch.empty((2, 4096, 4096), **f32),) * 2)
    assert rglru == (pytest.approx(1e3 * 4 * (3 * 2 * 4096 * 4096 + 2 * 4096) / 3.35e12), "bytes")  # ~0.120 ms
    dtA = torch.empty((2, 4096, 8192, 16), **f32)
    ssm = smoke.scan_bound("ssm_scan", (dtA, dtA, torch.empty((2, 4096, 16), **meta)))
    assert ssm[1] == "bytes" and ssm[0] == pytest.approx(2.6447, rel=1e-3)


def test_mamba_inputs_bound_and_cases(smoke):
    """The scan inputs' bytes bound at falcon-mamba-7b's 32k layer (dt_pre and x read,
    dtA and dBx written: ~10.6 ms), and small cases at every state size the scan takes,
    off a block's channel tile and its 64-row chunk, one position a row among them."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan.kernel import STATE_SIZES

    cfg = get_config("falcon-mamba-7b")
    B, S, D, N = smoke.MAMBA_INPUTS_32K
    assert (D, N, smoke.MAMBA_DT_RANK, B * S) == (cfg.d_inner, cfg.ssm_state, cfg.dt_rank, 32768)
    meta = {"device": "meta", "dtype": torch.bfloat16}
    proj = torch.empty((B, S, smoke.MAMBA_DT_RANK + 2 * N), **meta)
    args = (torch.empty((B, S, D), **meta), torch.empty((D,), **meta), torch.empty((D, N), device="meta"),
            torch.empty((B, S, D), **meta), proj[..., smoke.MAMBA_DT_RANK:smoke.MAMBA_DT_RANK + N])
    ms, by = smoke.mamba_inputs_bound(args)
    nbytes = 2 * 2 * B * S * D + 2 * B * S * N + 2 * D + 4 * D * N + 2 * 4 * B * S * D * N
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / 3.35e12) and 10.5 < ms < 10.7
    cases = smoke.MAMBA_INPUTS_CASES
    assert {c[3] for c in cases} == set(STATE_SIZES) and {c[4] for c in cases} == {"float32", "bfloat16"}
    assert any(c[2] % 256 and c[2] > 256 for c in cases) and any(c[1] == 1 for c in cases)
    assert any((c[0] * c[1]) % 64 and c[0] * c[1] > 64 for c in cases)
    assert smoke.MODEL_KERNELS["mamba_inputs"][1] is None and "mamba_inputs" in smoke.kernel_wrappers()


def test_backward_bound_and_shapes(smoke):
    """The backward's bound at glm4-9b's train shape (10 * D operations a visible pair and
    head: 0.695 ms), and every shape the smoke run holds takes the backward kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as flash

    meta = {"device": "meta", "dtype": torch.bfloat16}
    ms, by = smoke.backward_bound(torch.empty((2, 4096, 32, 128), **meta), torch.empty((2, 4096, 2, 128), **meta),
                                  True, 0, 0)
    assert by == "operations" and ms == pytest.approx(10 * 128 * 4096 * 4097 / 2 * 2 * 32 / 989e9)  # ~0.695 ms
    assert smoke.BACKWARD_SHAPES[0][1] == smoke.TRAIN_ARCH
    for _, arch, _, seq, _ in smoke.BACKWARD_SHAPES:
        cfg = get_config(arch)
        assert flash.backward_path("cuda", torch.bfloat16, cfg.d_head, sq=seq, sk=seq) == "kernel"


def test_first_calls_record_the_attentions_inputs_without_its_lse(smoke):
    """The recorded keywords are replayed into the plain version, which takes no ``lse``."""
    import types

    mod = types.SimpleNamespace(prepare=lambda *args, **kw: kw)
    q = torch.zeros((1, 8, 2, 16))
    with smoke.FirstCalls({"flash_attention": (mod, None, None)}) as calls:
        assert mod.prepare(q, q, q, causal=True, window=0, q_offset=0, lse=False)["lse"] is False
    assert calls.inputs["flash_attention"][1] == {"causal": True, "window": 0, "q_offset": 0}
    assert list(calls.shapes["flash_attention"].values())[0][1] == {"causal": True, "window": 0, "q_offset": 0}


def test_small_cases_cover_what_the_kernels_take(smoke):
    from repro_torch.kernels.flash_attention import kernel as flash

    cases = smoke.ATTN_CASES
    assert {c[4] for c in cases} >= {1, 2, 4, 6, 7, 8, 9, 12, 16}  # G, the served models' among them
    assert any(flash.TMA_ROWS % c[4] for c in cases)  # a G that divides no tile (H = 6, KV = 2)
    assert {c[5] for c in cases} >= set(flash.HEAD_DIMS)  # every D
    assert any(c[5] == 112 and c[4] == 8 and c[6] and c[1] % 64 for c in cases)  # kimi-k2's D and G, causal, ragged
    assert any(not c[6] for c in cases) and any(c[8] > 0 for c in cases)  # bidirectional, q_offset
    assert any(c[2] > c[1] and c[8] > 0 for c in cases)  # Sk > Sq with q_offset
    assert any(c[7] == 64 for c in cases) and any(0 < c[7] < c[2] for c in cases)  # window == tile, < S
    assert any(c[7] > c[2] for c in cases)  # a window past Sk
    # a window that is no multiple of the TMA body's kv tile
    assert any(c[5] in flash.TMA_KV_TILE and c[7] % flash.TMA_KV_TILE[c[5]] for c in cases)
    # lengths off the 64- and 128-key tiles, on the TMA body
    assert any(c[5] in flash.TMA_KV_TILE and c[1] % 64 and c[2] % 64 for c in cases)
    assert all(s % 4 for _, s, *_ in smoke.SSM_CASES) and all(s % 8 for _, s, _ in smoke.RGLRU_CASES)
    rglru_tma = [(s, w) for _, s, w in smoke.RGLRU_CASES if w % 4 == 0]  # the TMA body's widths
    assert any(s % 64 and w % 32 for s, w in rglru_tma)  # S off the 64-step chunk, W off 32 channels
    assert any(s >= 4096 for s, _ in rglru_tma)
    assert any(w % 4 for _, _, w in smoke.RGLRU_CASES)  # and the per-channel body


def test_served_models_and_their_launches(smoke):
    """Phase 11 serves every registered architecture; each one's expected flash /
    scan launches per prefill follow from its layer kinds (an enc-dec's encoder
    layers too), with the MoE models cut to MODEL_LAYERS."""
    import dataclasses

    from repro_torch.configs import PORTED_ARCHS, get_config
    from repro_torch.models import transformer as T

    assert {arch for arch, _ in smoke.MODELS} == set(PORTED_ARCHS)
    assert set(smoke.MODEL_LAYERS) == {a for a in PORTED_ARCHS if get_config(a).family == "moe"}
    for arch, expected in smoke.MODELS:
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, n_layers=smoke.MODEL_LAYERS.get(arch, cfg.n_layers))
        kinds = T.layer_kinds(cfg)
        flash = sum(kinds.count(k) for k in ("dense", "attn", "moe", "decoder")) + cfg.encoder_layers
        want = {"flash_attention": flash, "rglru_scan": kinds.count("rec"), "ssm_scan": kinds.count("mamba"),
                "mamba_inputs": kinds.count("mamba")}
        assert expected == {k: v for k, v in want.items() if v}, arch


def test_attention_body_names_the_kernels_body(smoke):
    meta = dict(device="meta")
    assert smoke.attention_body(torch.empty((1, 8, 64, 112), dtype=torch.bfloat16, **meta)).startswith(
        "wgmma+tma D=112 in the D=128 layout")
    assert smoke.attention_body(torch.empty((1, 8, 4, 128), dtype=torch.bfloat16, **meta)) == "wgmma+tma D=128"
    assert smoke.attention_body(torch.empty((1, 8, 4, 16), dtype=torch.bfloat16, **meta)) == "mma.sync D=16"
    assert smoke.attention_body(torch.empty((1, 8, 4, 112), dtype=torch.float32, **meta)) == "fma D=112"


def test_model_batch_carries_each_familys_inputs(smoke):
    from repro_torch.configs import get_smoke_config

    whisper, vlm = get_smoke_config("whisper-large-v3"), get_smoke_config("internvl2-1b")
    b = smoke.model_batch(whisper, "cpu", batch=2, prompt=10)
    assert tuple(b["frames"].shape) == (2, whisper.encoder_positions, whisper.d_model)
    b = smoke.model_batch(vlm, "cpu", batch=2, prompt=10)
    assert tuple(b["vision_embeds"].shape) == (2, vlm.vision_tokens, vlm.d_model)
    assert b["vision_mask"].sum(dim=1).tolist() == [vlm.vision_tokens] * 2 and bool(b["vision_mask"][:, 0].all())
    assert set(smoke.model_batch(get_smoke_config("glm4-9b"), "cpu", prompt=4)) == {"tokens"}


SASS_EXCERPT = """
\tcode for sm_90a
\t\tFunction : _ZN51_GLOBAL__N__8c2aef73_18_flash_attention_cu_23f0aea726flash_attention_tma_kernelILi128ELi128ELi2EEEv14CUtensorMap_stS1_S1_S1_NS_7TmaArgsE
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0390*/                   UTMALDG.4D [UR8], [UR14] ;
        /*0a40*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;
        /*0a50*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*1f00*/                   UTMASTG.4D [UR4], [UR6] ;
\t\tFunction : _ZN51_GLOBAL__N__8c2aef73_18_flash_attention_cu_23f0aea726flash_attention_tma_kernelILi64ELi128ELi2EEEv14CUtensorMap_stS1_S1_S1_NS_7TmaArgsE
        /*0a40*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;
\t\tFunction : _ZN51_GLOBAL__N__8c2aef73_18_flash_attention_cu_23f0aea726flash_attention_mma_kernelILi16ELi64EEEvNS_4ArgsE
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
\t\tFunction : _ZN46_GLOBAL__N__d8d86019_13_rglru_scan_cu_96a0881921rglru_scan_tma_kernelE14CUtensorMap_stS0_S0_Pfii
        /*0100*/                   UTMALDG.3D [UR8], [UR14] ;
        /*0110*/                   UTMALDG.3D [UR12], [UR14] ;
        /*0120*/                   UTMASTG.3D [UR4], [UR6] ;
\t\tFunction : _ZN46_GLOBAL__N__d8d86019_13_rglru_scan_cu_96a0881917rglru_scan_kernelEPKfS1_PfS2_xxx
        /*0100*/                   LDG.E R2, desc[UR4][R4.64] ;
"""


def test_sass_counter_counts_per_function_and_kernel(smoke):
    counts = smoke.sass_counts(SASS_EXCERPT)
    assert len(counts) == 5
    tma128 = next(ops for fn, ops in counts.items() if "tma_kernelILi128" in fn)
    assert tma128 == {"HGMMA": 2, "UTMALDG": 1, "UTMASTG": 1, "UBLKCP": 0}
    per_kernel = smoke.kernel_sass(counts)
    assert per_kernel["flash_attention_tma_kernel"] == {"functions": 2, "HGMMA": 3, "UTMALDG": 1, "UTMASTG": 1,
                                                         "UBLKCP": 0}
    assert per_kernel["flash_attention_mma_kernel"]["functions"] == 1
    assert per_kernel["flash_attention_mma_kernel"]["HGMMA"] == 0  # HMMA is not HGMMA
    assert per_kernel["rglru_scan_tma_kernel"] == {"functions": 1, "HGMMA": 0, "UTMALDG": 2, "UTMASTG": 1, "UBLKCP": 0}
    # rglru_scan_kernel is a suffix of no other name but must not pick up rglru_scan_tma_kernel
    assert per_kernel["rglru_scan_kernel"] == {"functions": 1, "HGMMA": 0, "UTMALDG": 0, "UTMASTG": 0, "UBLKCP": 0}
    assert smoke.kernel_sass({}) == {name: dict(functions=0, **dict.fromkeys(smoke.SASS_OPS, 0))
                                     for name in smoke.SASS_KERNELS}


def test_refuses_to_run_without_a_gpu(smoke, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert smoke.main() == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_codec_bound_and_cases(smoke):
    emb = torch.empty((151552, 4096), device="meta", dtype=torch.bfloat16)
    ms, by = smoke.codec_bound(emb)
    n = 151552 * 4096
    assert by == "bytes" and ms == pytest.approx(1e3 * (2 * n + n // 256 * 260) / 3.35e12)  # ~0.559 ms
    assert smoke.codec_bound(torch.empty(257, device="meta"))[0] == pytest.approx(1e3 * (4 * 257 + 2 * 260) / 3.35e12)
    assert {1, 255, 256, 257, 1000, 4096, (1 << 20) + 3} <= set(smoke.CODEC_SIZES)
    assert "ckpt_codec" in smoke.kernel_wrappers()


def test_adamw_phase_constants_inputs_and_row(smoke):
    from repro_torch.optim import AdamWConfig

    cfg = AdamWConfig(lr=1e-4, moment_dtype="float32")  # the training phase's
    assert smoke.ADAMW_CONSTS == (cfg.b1, cfg.b2, 1 - cfg.b1, 1 - cfg.b2, cfg.eps, cfg.weight_decay)
    p = torch.randn(1000).bfloat16()
    g, mu, nu, step = smoke.adamw_inputs(p, torch.float32, seed=3)
    assert (g.dtype, mu.dtype, nu.dtype, step.shape) == (torch.bfloat16, torch.float32, torch.float32, (4,))
    assert bool((nu >= 0).all()) and float(torch.linalg.vector_norm(g.float() * step[0])) == pytest.approx(1.0)
    assert float(step[1]) == pytest.approx(1 - 0.9**3) and float(step[2]) == pytest.approx(1 - 0.95**3)
    row = smoke.adamw_row({"ms": 2.0, "bound_ms": 1.0}, {"training": 63, "campaign": 42, "mesh": 84})
    assert row["name"] == "adamw" and row["replaces"] is None and row["launches"] == 189
    assert row["source"] == "src/repro_torch/kernels/adamw/csrc/adamw.cu" and "adamw" in smoke.kernel_wrappers()


def test_training_config_is_glm4_at_its_published_widths(smoke):
    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.checkpoint.manager import quantized
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = smoke.train_cfg()
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab_size, cfg.rope_theta) == (
        4096, 32, 2, 128, 13696, 151552, 1e6)
    assert cfg.n_layers == smoke.TRAIN_LAYERS == 4 and cfg.dtype == "bfloat16"
    params = T.init_params(cfg, seed=0, device="meta")
    n = sum(x.numel() for x in tree_lib.leaves(params))
    embed = 2 * 151552 * 4096
    assert n - embed == 4 * 203_956_224 + 4096  # four layers of 203.96 M (norms included) + the final norm
    assert n == pytest.approx(2.057e9, rel=1e-3)
    state = (params, adamw_init(params, AdamWConfig(moment_dtype="float32")))
    # bf16 weights and float32 mu / nu: 10 bytes a parameter (12 with the bf16 gradients of a step)
    assert sum(x.numel() * x.element_size() for x in tree_lib.leaves(state)) == 10 * n + 4
    ckpt = sum(-(-x.numel() // 256) * 260 for x in tree_lib.leaves(state) if quantized(x, "int8"))
    assert ckpt == pytest.approx(6.27e9, rel=1e-3)  # the int8 checkpoint
    assert sum(quantized(x, "int8") for x in tree_lib.leaves(state)) == 3 * 39  # params, mu, nu; not the step
    assert smoke.CAMPAIGN["codec"] == "int8" and smoke.CAMPAIGN["keep"] == 2


def small_sweep(smoke, name, schemes=None):
    """A small study's sweep through the plain version on the CPU: its
    arguments (with ``schemes`` in place of the study's, if given) and outputs."""
    from repro_torch.kernels.spot_sweep import ref

    args = smoke.sweep_args(smoke.small_studies()[name], torch.device("cpu"))
    if schemes is not None:
        args = (schemes, *args[1:])
    return args, ref.sweep_plain(*args)


def processed_periods(args, out) -> np.ndarray:
    """(S, C): the valid periods each (scheme, cell) walks, up to the completing one."""
    valid = args[3].numpy()
    done, user = out[0].numpy(), out[7].numpy()
    P = valid.shape[1]
    p_done = np.where(done, user.argmax(axis=2), P - 1)
    return (valid[None] & (np.arange(P) <= p_done[..., None])).sum(axis=2)


@pytest.mark.parametrize("name", ["synthetic", "resume_extreme_bids", "step_trace_edges", "golden_grid"])
def test_chain_steps_cover_every_processed_period(smoke, name):
    args, out = small_sweep(smoke, name)
    steps = smoke.chain_steps(args, out)
    per_row = processed_periods(args, out)
    assert steps >= per_row.max() > 0
    processed, walk_steps, _ = smoke.sweep_work(args, out)
    assert np.array_equal(processed.sum(axis=2), per_row)
    assert steps == (per_row + walk_steps.sum(axis=2)).max()
    assert steps > per_row.max()  # the walking schemes add windows and ticks


def test_chain_steps_of_none_and_opt_are_their_periods(smoke):
    from repro_torch.core.schemes import Scheme

    args, out = small_sweep(smoke, "golden_grid", (Scheme.NONE, Scheme.OPT))
    assert smoke.chain_steps(args, out) == processed_periods(args, out).max()


def test_sweep_row_reports_the_time_a_step_takes(smoke):
    row = smoke.sweep_row(1, 0.0, 0.3125, 1717.4, (0.0404, "bytes"), 0.35, {"adapt": 0.3}, 625)
    assert row["ns_per_step"] == 0.3125 * 1e6 / 625 == 500.0
    assert row["chain_steps"] == 625 and row["by_scheme"] == {"adapt": 0.3}
    assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"} <= set(row)
    assert (row["bound_ms"], row["bound_by"], row["library_ms"], row["route"]) == (0.0404, "bytes", None, "cuda")


def test_acc_phase_runs_every_study_with_all_six_schemes(smoke):
    from repro_torch.engine import ALL_SCHEMES

    for name, sc in smoke.small_studies().items():
        six = smoke.six_schemes(sc)
        assert six.schemes == ALL_SCHEMES, name
        assert {k: v for k, v in six.canonical().items() if k != "schemes"} == {
            k: v for k, v in sc.canonical().items() if k != "schemes"
        }
    full = smoke.full_study(ALL_SCHEMES)
    assert full.n_cells == 62976 and full.n_markets * len(full.bids) == 10496
    assert smoke.full_study().schemes == smoke.full_study(None).schemes != ALL_SCHEMES
    assert set(smoke.ACC_FIELDS) == set(smoke.FIELDS) | {"n_self_terminations"}


def ref_scenario(sc):
    """The JAX package's study of a port study over a generated market."""
    from repro.core import catalog as ref_catalog
    from repro.engine import Scenario as RefScenario
    from repro.market import MarketParams as RefMarketParams

    canon = sc.canonical()
    by_name = {it.name: it for it in ref_catalog()}
    from repro.core import Scheme as RefScheme

    rsc = RefScenario.grid(
        work_s=canon["work_s"], bids=canon["bids"], instances=[by_name[it["name"]] for it in canon["instances"]],
        schemes=tuple(RefScheme(v) for v in canon["schemes"]), horizon_days=canon["horizon_days"],
        seeds=canon["seeds"], bid_fractions=canon["bid_fractions"], capacity=canon["capacity"],
        demand=canon["demand"], market=RefMarketParams(**canon["market"]),
    )
    assert rsc.canonical() == canon
    return rsc


def test_capacity_golden_digest_is_the_reference_result(smoke):
    """``chip_smoke.py`` holds the card's contended golden study against a
    pinned digest: the digest of ``repro``'s batch engine on the same study."""
    from repro.engine import run as ref_run

    from repro_torch.engine import ALL_SCHEMES, run

    sc = smoke.capacity_golden_study()
    assert sc.schemes == ALL_SCHEMES and (sc.capacity, sc.demand) == (smoke.CAPACITY, smoke.BINDING_DEMAND) == (4, 3)
    assert smoke.result_digest(ref_run(ref_scenario(sc), "batch"), smoke.ACC_FIELDS) == smoke.GOLDEN_CAPACITY_SHA256
    assert smoke.result_digest(run(sc, device="cpu"), smoke.ACC_FIELDS) == smoke.GOLDEN_CAPACITY_SHA256


def test_fleet_golden_digests_are_the_reference_records(smoke):
    """The small fleet grids (every scheme) and the contended fleet replay:
    the pinned digests are those of ``repro``'s records, and the port's CPU
    run gives them too."""
    from repro.core import Scheme as RefScheme
    from repro.core import constant_trace as ref_constant_trace
    from repro.core import get_instance as ref_get_instance
    from repro.engine import FleetScenario as RefFleetScenario
    from repro.engine import run_fleet as ref_run_fleet
    from repro import fleet as RF

    from repro_torch.core import HOUR, Scheme
    from repro_torch.engine import run_fleet

    scenarios = smoke.golden_fleet_scenarios()
    assert [fs.scheme for fs in scenarios] == list(Scheme)
    want = []
    for fs in scenarios:
        canon = fs.canonical()
        rfs = RefFleetScenario(n_jobs=12, mean_interarrival_s=1800.0, mean_work_h=3.0, horizon_days=4.0, n_types=8,
                               seeds=(0, 1), scheme=RefScheme(canon["scheme"]))
        assert rfs.canonical() == canon
        want.append(ref_run_fleet(rfs, engine="batch").results)
    assert smoke.fleet_digest(want) == smoke.GOLDEN_FLEET_SHA256
    assert smoke.fleet_digest([run_fleet(fs, device="cpu").results for fs in scenarios]) == smoke.GOLDEN_FLEET_SHA256

    it = ref_get_instance("m1.xlarge", region="us-east-1")
    traces = {it.name: ref_constant_trace(0.36, 60 * HOUR)}
    wl = RF.Workload.from_sizes([6.0] * 4, interarrival_s=0.5 * HOUR)
    replay = {}
    for label, kwargs in (("infinite depth", {}), ("capacity-limited", {"capacity": 4}),
                          ("capacity + re-bid", {"capacity": 4, "bid_policy": RF.ClearingRebid(0.56, 0.10)})):
        replay[label] = RF.FleetController([it], traces, RF.CostGreedyPolicy(), scheme=RefScheme.HOUR,
                                           bid_margin=0.56, **kwargs).run(wl)
    assert smoke.fleet_digest([replay]) == smoke.GOLDEN_REPLAY_SHA256


def test_fleet_and_capacity_studies_are_the_stated_configurations(smoke):
    fs = smoke.fleet_full_scenario()
    assert (fs.n_jobs, fs.n_types, fs.seeds, fs.bid_margins, fs.horizon_days) == (
        200, 64, tuple(range(8)), (0.54, 0.56, 0.60), 21.0)
    assert fs.scheme.value == "hour" and len(fs.policies) * len(fs.seeds) * len(fs.bid_margins) == 96
    assert smoke.fleet_full_scenario(smoke.CONTROLLER_SEEDS).seeds == (0, 1)
    cap = smoke.capacity_study()
    assert cap.n_cells == 52480 and cap.capacity == 4 and cap.demand == 2
    assert smoke.capacity_study(smoke.BINDING_DEMAND).demand == 3
    assert cap.market == type(cap.market)()
    assert {k: v for k, v in cap.canonical().items() if k not in ("capacity", "demand")} == {
        k: v for k, v in smoke.full_study().canonical().items() if k not in ("capacity", "demand")}
    small = smoke.small_capacity_studies()
    assert {sc.demand for name, sc in small.items() if name.startswith("market_contention")} == {1, 2, 3, 4}
    assert all(sc.capacity is not None for sc in small.values())


def test_autoscale_golden_digest_is_the_reference_result(smoke):
    """The small serving grids: the pinned digest is that of ``repro``'s
    batch engine, and the port's CPU batch engine and host reference give
    it too."""
    from repro.serving import ServingScenario as RefServingScenario
    from repro.serving import run_serving as ref_run_serving

    from repro_torch.serving import run_serving

    grids = smoke.autoscale_small_grids()
    assert [sc.capacity for sc in grids.values()] == [None, 12, 12]
    assert all(sc.flash_crowds and sc.policies == ("target", "threshold", "hazard") for sc in grids.values())
    want = []
    for sc in grids.values():
        ref = RefServingScenario(base_rps=sc.base_rps, flash_crowds=sc.flash_crowds, horizon_days=sc.horizon_days,
                                 seeds=sc.seeds, bid_margins=sc.bid_margins, capacity=sc.capacity,
                                 max_spot=sc.max_spot)
        assert ref.canonical() == sc.canonical()
        want.append(ref_run_serving(ref, engine="batch"))
    assert smoke.serving_digest(want) == smoke.GOLDEN_AUTOSCALE_SHA256
    for engine, device in (("batch", "cpu"), ("reference", None)):
        got = [run_serving(sc, engine=engine, device=device) for sc in grids.values()]
        assert smoke.serving_digest(got) == smoke.GOLDEN_AUTOSCALE_SHA256
    assert set(smoke.SERVING_FIELDS) == {
        f.name for f in __import__("dataclasses").fields(want[0]) if f.name not in (
            "policies", "bid_margins", "seeds", "spot_types", "engine", "wall_s")}


def test_autoscale_grids_are_the_benchmarks(smoke):
    """``autoscale_bench_scenario`` is ``benchmarks/serving_bench.py``'s
    ``bench_scenario`` (full and quick), and the wide grid is the full one at
    seeds 0-63 (576 cells)."""
    spec = importlib.util.spec_from_file_location("serving_bench", ROOT / "benchmarks/serving_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for quick in (False, True):
        assert smoke.autoscale_bench_scenario(quick=quick).canonical() == bench.bench_scenario(quick).canonical()
    full = smoke.autoscale_bench_scenario()
    assert (full.n_cells, full.n_periods, full.capacity, full.max_spot) == (72, 1152, 12, 16)
    wide = smoke.autoscale_bench_scenario(capacity=None, seeds=smoke.WIDE_SEEDS)
    assert (wide.n_cells, wide.capacity) == (576, None)


def test_parallel_phase_cuts_and_tolerances(smoke):
    from repro_torch.configs import get_config

    cuts, tol = smoke.parallel_cuts(), smoke.parallel_tolerances()
    assert set(cuts) == {"compression", "sp_decode", "ep_moe"}
    assert cuts["compression"] == {"model": "glm4-9b", "layers": 4, "of_layers": 40}
    sp = smoke.sp_cfg()
    # internlm2-20b's published attention widths, 8 of its 48 layers
    assert (sp.n_heads, sp.n_kv_heads, sp.d_head, sp.d_model, sp.n_layers) == (48, 8, 128, 6144, 8)
    assert get_config(smoke.SP_ARCH).n_layers == cuts["sp_decode"]["of_layers"] == 48
    ranks, cache, prompt, steps = smoke.PARALLEL_RANKS, smoke.SP_CACHE, smoke.SP_PROMPT, smoke.SP_STEPS
    assert (ranks, cache, cache // ranks) == (4, 32768, 8192)
    # the prompt fills three ranks' slices and reaches into the fourth, where every step appends
    assert 3 * cache // ranks < prompt and prompt + steps <= cache
    ep = get_config(smoke.EP_ARCH)
    assert (ep.n_experts, ep.n_experts // ranks, ep.top_k, ep.d_model, ep.d_ff) == (128, 32, 2, 7168, 4864)
    assert cuts["ep_moe"]["tokens"] == 2 * 4096
    assert tol["sp_decode_logits"] == smoke.LOGITS_TOL and tol["ep_moe_y_bf16_ulps"] == smoke.EP_ULPS == 1
    assert tol["sp_merge_of_scale"] == smoke.SP_MERGE_TOL == 1e-2 and tol["sp_prefill_flash"] == smoke.ATTN_TOL["bfloat16"]
    assert tol["ep_moe_load_balance_rtol"] == 1e-5


def test_compression_sample_names_leaves_of_the_training_model(smoke):
    from repro_torch.models import transformer as T

    tree = T.abstract_params(smoke.train_cfg())
    shapes = [tuple(smoke.tree_at(tree, p).shape) for p in smoke.COMPRESS_SAMPLE]
    assert shapes == [(4096,), (4096,), (4096, 2, 128), (4096, 32, 128), (13696, 4096)]
    assert smoke.COMPRESS_STEPS == 3


def test_error_feedback_check_and_bits(smoke):
    from repro_torch.optim import compress as C

    gen = torch.Generator().manual_seed(0)
    g = {"w": torch.randn(1000, generator=gen).to(torch.bfloat16)}
    state = C.compress_gradients_init(g)
    r_old = state.residual["w"]
    sent, state = C.compressed_grad_transform(g, state)
    assert smoke.ef_violation(sent["w"], g["w"], r_old, state.residual["w"]) <= 1.0
    broken = sent["w"].clone()
    broken[7] += 1.0
    assert smoke.ef_violation(broken, g["w"], r_old, state.residual["w"]) > 1.0
    x = torch.tensor([0.0, 1.5])
    assert smoke.same_bits(x, x.clone()) and not smoke.same_bits(x, torch.tensor([-0.0, 1.5]))
    assert not smoke.same_bits(x, x.to(torch.bfloat16))


def test_bf16_ulps_counts_each_elements_own_ulp(smoke):
    want = torch.tensor([1.0, 300.0, -0.01, 0.0], dtype=torch.bfloat16)
    assert smoke.bf16_ulps(want, want) == 0.0
    step = torch.tensor([2.0 ** -7, 2.0, 2.0 ** -14, 0.0])  # one ulp of each (bf16 keeps 8 significant bits)
    assert smoke.bf16_ulps(want.float() + step, want) == pytest.approx(1.0)
    assert smoke.bf16_ulps(want.float() + 3 * step, want) == pytest.approx(3.0)
    assert smoke.bf16_ulps(torch.tensor([1.0, 300.0, -0.01, 1e-30]), want.float()) == float("inf")  # 0 is exact


def test_recorder_keeps_every_nth_call_and_restores(smoke):
    import types

    mod = types.SimpleNamespace(f=lambda x, y=0: x + y)
    with smoke.Recorder(mod, "f", every=3, limit=2) as rec:
        assert [mod.f(i, y=1) for i in range(10)] == list(range(1, 11))
    assert [(a, kw, out) for a, kw, out in rec.calls] == [((0,), {"y": 1}, 1), ((3,), {"y": 1}, 4)]
    assert mod.f(1) == 1 and rec.n == 10


def test_sp_merge_check_passes_the_merge_and_catches_broken_ones(smoke):
    from repro_torch.kernels.flash_attention.ref import decode_attention

    gen = torch.Generator().manual_seed(0)
    k, v = (torch.randn((1, 64, 2, 16), generator=gen).to(torch.bfloat16) for _ in range(2))
    calls = []
    for pos in (40, 41):  # rank 3's slice (48..63) is still empty: its partial must weigh 0
        q = torch.randn((1, 1, 6, 16), generator=gen).to(torch.bfloat16)
        parts = smoke.sp_partials(q, k, v, pos, 4)
        merged = smoke.merge_partials(parts, q.shape, q.dtype)
        assert smoke.bf16_ulps(merged, decode_attention(q, k, v, pos + 1)) <= 1
        calls.append((q, pos, merged))
    out = smoke.sp_merge_check(calls, k, v, 4, device="cpu")
    assert out["max_abs_err"] <= out["bound"] < min(out["broken_merges"].values()) and out["steps"] == 2
    wrong = [(q, pos, smoke.merge_partials(smoke.sp_partials(q, k, v, pos, 4), q.shape, q.dtype, "rank0_dropped"))
             for q, pos, _ in calls]
    with pytest.raises(AssertionError, match="merged attention"):
        smoke.sp_merge_check(wrong, k, v, 4, device="cpu")


def test_hold_flash_prefill_chunks_the_queries(smoke):
    from repro_torch.kernels.flash_attention.ref import naive_attention

    gen = torch.Generator().manual_seed(1)
    n = smoke.SP_CHUNK + 40  # two chunks, the second ragged
    q, k, v = (torch.randn((1, n, h, 16), generator=gen).to(torch.bfloat16) for h in (4, 2, 2))
    out = naive_attention(q, k, v)
    assert smoke.hold_flash_prefill(((q, k, v), {"causal": True}, out)) == 0.0
    late = out.clone()
    late[:, -1] += 1.0  # the last query of the ragged chunk
    with pytest.raises(AssertionError, match="queries 512"):
        smoke.hold_flash_prefill(((q, k, v), {"causal": True}, late))


def test_first_of_each_keeps_one_call_a_shape_and_keyword_set(smoke):
    import types

    mod = types.SimpleNamespace(f=lambda x, causal=True: x + 1)
    a, b = torch.zeros(2, 3), torch.zeros(4)
    with smoke.FirstOfEach(mod, "f") as rec:
        for x, causal in ((a, True), (a + 1, True), (b, True), (a, False), (b, True)):
            mod.f(x, causal=causal)
    assert [(tuple(args[0].shape), kw) for args, kw, _ in rec.calls] == [
        ((2, 3), {"causal": True}), ((4,), {"causal": True}), ((2, 3), {"causal": False})]
    assert float(rec.calls[0][2].sum()) == 6.0 and mod.f(a).shape == (2, 3)


@pytest.mark.parametrize("name", ["flash_attention", "rglru_scan", "ssm_scan", "mamba_inputs"])
def test_hold_local_calls_passes_the_plain_result_and_catches_a_wrong_one(smoke, name):
    gen = torch.Generator().manual_seed(2)
    if name == "flash_attention":
        args = tuple(torch.randn((1, 40, h, 16), generator=gen).to(torch.bfloat16) for h in (4, 2, 2))
        kw = {"causal": False, "window": 0, "q_offset": 0}  # the whisper encoder's bidirectional layers
    elif name == "rglru_scan":
        args, kw = (-torch.rand((1, 30, 8), generator=gen), torch.randn((1, 30, 8), generator=gen)), {}
    elif name == "mamba_inputs":
        args, kw = (torch.randn((1, 30, 6), generator=gen), torch.randn((6,), generator=gen),
                    torch.randn((6, 4), generator=gen), torch.randn((1, 30, 6), generator=gen),
                    torch.randn((1, 30, 9), generator=gen)[..., 5:]), {}
    else:
        args, kw = (-torch.rand((1, 30, 6, 4), generator=gen), torch.randn((1, 30, 6, 4), generator=gen),
                    torch.randn((1, 30, 4), generator=gen)), {}
    from repro_torch.kernels.flash_attention.ref import naive_attention

    plain = naive_attention if name == "flash_attention" else smoke.model_kernel_modules()[name][2]
    out = plain(*args, **kw)
    held = smoke.hold_local_calls(name, [(args, kw, out)])
    assert held == {"max_abs_err": 0.0, "shapes": [[list(a.shape) for a in args]]}
    wrong = out.clone() if name == "flash_attention" else tuple(o.clone() for o in out)
    (wrong if name == "flash_attention" else wrong[0])[0, -1] += 0.5
    with pytest.raises(AssertionError, match=f"placed {name}"):
        smoke.hold_local_calls(name, [(args, kw, out), (args, kw, wrong)])


def test_mesh_phase_cuts_tolerances_and_line(smoke):
    from repro_torch.configs import get_config

    cuts, tol = smoke.mesh_cuts(), smoke.mesh_tolerances()
    assert set(cuts) == {"train", "scans", "elastic"} and set(tol) == {"loss_and_grad_norm", "restored_shards"}
    assert tol["loss_and_grad_norm"] is smoke.TRAIN_LOSS_TOL
    assert smoke.MESH_SHAPE == (2, 2) and smoke.MESH_AXES == ("data", "model")
    # (a): phase 14's model and depth at half its sequence; a warm-up and a timed step
    assert (cuts["train"]["model"], cuts["train"]["layers"], cuts["train"]["of_layers"]) == ("glm4-9b", 4, 40)
    assert (smoke.MESH_BATCH, 2 * smoke.MESH_SEQ, smoke.MESH_STEPS) == (smoke.TRAIN_BATCH, smoke.TRAIN_SEQ, 2)
    # (b): published widths, cut depth, the kernels each rank launches once a layer of their kind
    for arch, layers, launches in smoke.MESH_SCAN_MODELS:
        full = get_config(arch)
        assert layers < full.n_layers and cuts["scans"][arch]["layers"] == layers
    assert dict((a, l) for a, _, l in smoke.MESH_SCAN_MODELS) == {
        "falcon-mamba-7b": {"ssm_scan": 2, "mamba_inputs": 2},
        "recurrentgemma-9b": {"rglru_scan": 2, "flash_attention": 1}}
    # (c): the example's two launches at (a)'s widths and depth, int8, 2 ranks then 4, two steps each
    run = smoke.elastic_run("/nowhere")
    cfg = run.config()
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size, cfg.n_layers) == (
        4096, 32, 2, 13696, 151552, 4)
    assert (cuts["elastic"]["model"], cuts["elastic"]["first_mesh"]) == ("glm4-9b", [2])
    assert (run.second_mesh, run.steps, run.codec) == ((2, 2), 2, "int8")
    assert (run.batch, run.seq, run.moment_dtype) == (smoke.MESH_BATCH, smoke.MESH_SEQ, smoke.MESH_MOMENTS)
    assert smoke.MESH_LINE_KEYS == ("card", "ranks", "mesh", "backend", "parent_gb_at_start", "train", "scans",
                                    "elastic", "launches", "phase_s", "cuts", "tolerances")
    assert smoke.held(1.0, 1.01, 0.02) and not smoke.held(1.0, 1.1, 0.02)


def test_placed_serving_phase_cases_tolerances_and_line(smoke):
    from repro_torch.configs import get_config

    cases = {c[0]: c for c in smoke.PLACED_CASES}
    assert set(cases) == {"glm4-9b", "glm4-9b_sp_kv", "recurrentgemma-9b", "falcon-mamba-7b", "arctic-480b",
                          "arctic-480b_ep", "whisper-large-v3", "internvl2-1b"}
    assert smoke.PLACED_SHAPE == (2, 2) and smoke.PLACED_AXES == ("data", "model") and smoke.PLACED_BATCH == 2
    # (a): phase 14's model and depth, 2 x 2048 into 4096 slots, 8 steps; then kv_seq on model
    for name in ("glm4-9b", "glm4-9b_sp_kv"):
        assert cases[name][1:6] == ("glm4-9b", smoke.TRAIN_LAYERS, 2048, 4096, 8)
        assert cases[name][7] == (2, 2) and cases[name][9] == {"flash_attention": smoke.TRAIN_LAYERS}
    assert cases["glm4-9b"][6] == {} and cases["glm4-9b_sp_kv"][6] == {"kv_seq": "model"}
    # (b): phase 17's depths; recurrentgemma's window cache is full after the prompt and wraps in decode
    scans = {arch: (layers, want) for arch, layers, want in smoke.MESH_SCAN_MODELS}
    for arch in ("recurrentgemma-9b", "falcon-mamba-7b"):
        assert (cases[arch][2], cases[arch][9]) == scans[arch] and cases[arch][3:6] == (2048, 4096, 8)
    assert get_config("recurrentgemma-9b").window == 2048 < cases["recurrentgemma-9b"][4]
    # (c): one arctic layer on 1 x 4 (32 experts a rank, a data axis of 1: no FSDP gather), both MoE paths
    for name in ("arctic-480b", "arctic-480b_ep"):
        assert cases[name][1:6] == ("arctic-480b", 1, 1024, 2048, 4) and cases[name][7] == smoke.PLACED_MOE_SHAPE
        assert smoke.PLACED_MOE_SHAPE == (1, 4) and get_config("arctic-480b").n_experts // 4 == 32
    assert cases["arctic-480b"][8] == {} and cases["arctic-480b_ep"][8] == {"moe_impl": "ep"}
    # (d): full depth, 2 x 1024 and 8 steps; flash attention once a self-attention layer
    assert cases["whisper-large-v3"][2] is None and cases["whisper-large-v3"][9] == {"flash_attention": 64}
    assert cases["internvl2-1b"][2] is None and cases["internvl2-1b"][9] == {"flash_attention": 24}
    assert smoke.PLACED_LOSS == (("whisper-large-v3", 512), ("internvl2-1b", 512))
    # (e)
    assert smoke.PLACED_DRYRUN == (("glm4-9b", "decode_32k", "single", "baseline"),
                                   ("arctic-480b", "prefill_32k", "multi", "ep_moe"))
    cuts, tol = smoke.placed_cuts(), smoke.placed_tolerances()
    assert cuts["whisper-large-v3"]["layers"] == cuts["whisper-large-v3"]["of_layers"] == 32
    assert (cuts["arctic-480b"]["layers"], cuts["arctic-480b"]["of_layers"]) == (1, 35)
    assert tol["loss_and_grad_norm"] is smoke.TRAIN_LOSS_TOL and str(smoke.LOGITS_TOL) in tol["logits"]
    assert smoke.PLACED_LINE_KEYS == ("card", "ranks", "backend", "cases", "loss", "dryrun", "launches",
                                      "kernel_vs_plain", "rank_peak_memory_gb", "parent_gb", "phase_s", "cuts",
                                      "tolerances")
    got, want = torch.zeros(2, 3), torch.tensor([[0.0, 4.0, -1.0], [0.5, 0.0, 0.0]])
    assert smoke.logits_err(got, want) == (4.0, 4.0)


def test_shard_checksums_see_every_bit(smoke):
    from repro_torch.launch import elastic_restart as E

    x = torch.randn((8, 6), generator=torch.Generator().manual_seed(0)).bfloat16()
    assert E.slice_digest(x, (2, 3), (4, 3)) == E.bits_digest(x[2:6, 3:6].clone())
    for i in range(x.numel()):  # one bit of any element changes the checksum
        y = x.clone()
        y.view(-1).view(torch.int16)[i] ^= 1
        assert E.bits_digest(y) != E.bits_digest(x)
    z = torch.zeros(4)
    assert E.bits_digest(z) != E.bits_digest(-z)  # -0.0 is another word
