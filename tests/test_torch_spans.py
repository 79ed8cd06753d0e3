"""The program's spans on its model paths (:mod:`repro_torch.obs`).

A train step records ``train.step`` holding ``train.forward``,
``train.backward`` and ``train.adamw``; a prefill ``prefill`` holding one
``prefill.ssm_inputs`` a Mamba layer; a decode step ``decode.step`` holding
one ``decode.mixer`` a layer; a kernel launch ``kernel.<name>`` and its
backward ``kernel.<name>.recompute``.  While a torch profiler records, each
span is also a ``repro_torch.<name>`` range, with or without a collector;
with neither, a span is the shared no-op context: no ``Span``, no range.
The spans change no result: the same bits with them on and off.
"""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _launch
from repro_torch.models import transformer as T
from repro_torch.obs import telemetry
from repro_torch.optim import AdamWConfig
from repro_torch.train.steps import make_train_state, make_train_step

BLOCK = 8


def _batch(cfg, rows=2, seq=16, seed=1):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (rows, seq + 1), generator=gen)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def _train_once(arch="glm4-9b"):
    cfg = get_smoke_config(arch)
    state = make_train_state(cfg, AdamWConfig(), seed=0, device="cpu")
    step = make_train_step(cfg, AdamWConfig(), remat=False, q_block=BLOCK, kv_block=BLOCK)
    return step(state.params, state.opt_state, _batch(cfg))


def _serve_once(arch, new_tokens=2):
    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, 0, device="cpu")
    tokens = _batch(cfg, seq=8)["tokens"]
    logits, cache = T.prefill(cfg, params, {"tokens": tokens}, 8 + new_tokens, q_block=BLOCK, kv_block=BLOCK,
                              device="cpu")
    out = [logits]
    for _ in range(new_tokens):
        logits, cache = T.decode_step(cfg, params, torch.argmax(logits[:, -1:], -1).to(torch.int32), cache,
                                      device="cpu")
        out.append(logits)
    return cfg, out


def _tree(spans):
    return [(s.name, _tree(s.children)) for s in spans]


def test_a_train_step_records_its_three_parts_in_order():
    with obs.Telemetry() as tel:
        _train_once()
    assert _tree(tel.spans) == [("train.step", [("train.forward", []), ("train.backward", []),
                                                ("train.adamw", [])])]
    assert tel.spans[0].attrs == {"tokens": 32}
    parts = tel.spans[0].children
    assert all(a.t0 + a.dur <= b.t0 for a, b in zip(parts, parts[1:]))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "glm4-9b", "recurrentgemma-9b"])
def test_prefill_and_decode_record_a_span_a_layer(arch):
    with obs.Telemetry() as tel:
        cfg, _ = _serve_once(arch)
    mamba = sum(kind == "mamba" for kind in T.layer_kinds(cfg))
    assert _tree(tel.spans) == ([("prefill", [("prefill.ssm_inputs", [])] * mamba)]
                                + [("decode.step", [("decode.mixer", [])] * cfg.n_layers)] * 2)
    assert tel.spans[0].attrs == {"rows": 2, "ids": 16}
    assert [s.attrs for s in tel.spans[1:]] == [{"pos": 8}, {"pos": 9}]


def test_nothing_is_recorded_or_opened_without_a_collector_or_profiler(monkeypatch):
    opened, made = [], []

    class Range:
        def __init__(self, name):
            opened.append(name)

    class CountedSpan(telemetry.Span):
        def __init__(self, **fields):
            made.append(fields["name"])
            super().__init__(**fields)

    monkeypatch.setattr(telemetry._profiler, "record_function", Range)
    monkeypatch.setattr(telemetry, "Span", CountedSpan)
    assert obs.current() is obs.NULL and not telemetry.profiling()
    assert obs.current().span("decode.step", pos=1) is telemetry._NULL_SPAN_CTX
    _train_once()
    _serve_once("falcon-mamba-7b")
    assert opened == [] and made == []
    with obs.Telemetry() as tel:  # the counting classes are the ones a recording span uses
        with tel.span("train.step"):
            pass
    assert made == ["train.step"] and opened == []


@pytest.mark.parametrize("collector", [False, True])
def test_the_spans_are_profiler_ranges_while_it_records(collector):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if collector:
            with obs.Telemetry() as tel:
                _serve_once("falcon-mamba-7b", new_tokens=1)
        else:
            _serve_once("falcon-mamba-7b", new_tokens=1)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith(telemetry.RANGE_PREFIX)]
    assert sorted(set(names)) == ["repro_torch.decode.mixer", "repro_torch.decode.step", "repro_torch.prefill",
                                  "repro_torch.prefill.ssm_inputs"]
    assert names.count("repro_torch.prefill.ssm_inputs") == names.count("repro_torch.decode.mixer") == 2
    if collector:
        assert [s.name for s in tel.spans] == ["prefill", "decode.step"]


def test_results_are_the_same_bits_with_the_spans_on():
    params_off, _, metrics_off = _train_once()
    _, logits_off = _serve_once("falcon-mamba-7b")
    with profile(activities=[ProfilerActivity.CPU]), obs.Telemetry() as tel:
        params_on, _, metrics_on = _train_once()
        _, logits_on = _serve_once("falcon-mamba-7b")
    assert len(tel.spans) == 4
    assert torch.equal(metrics_off["loss"], metrics_on["loss"])
    assert all(torch.equal(params_off[k], params_on[k]) for k in params_off if k != "layers")
    assert all(torch.equal(a[k], b[k]) for a, b in zip(params_off["layers"], params_on["layers"]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(logits_off, logits_on))


def test_a_launch_and_a_recompute_record_their_kernel_spans():
    out = torch.zeros(3)
    x, g = torch.arange(3.0), torch.ones(3)
    refused = _launch.Launch(lambda *args: 700, (), (), (out,))
    with obs.Telemetry() as tel:
        assert _launch.call("fake", _launch.Launch(lambda *args: 0, (1, 2), (), (out,))) == (out,)
        (grad,) = _launch.recompute_grads("fake", lambda a: a * a, (x,), (True,), (g,))
        with pytest.raises(RuntimeError, match="fake kernel launch failed with CUDA error 700"):
            _launch.call("fake", refused)
    assert [s.name for s in tel.spans] == ["kernel.fake", "kernel.fake.recompute", "kernel.fake"]
    assert torch.equal(grad, 2 * x)
