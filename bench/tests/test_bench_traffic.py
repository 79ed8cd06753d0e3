"""The one generator: the same seed gives the same inputs, another seed other
inputs, and every seed the same batch kinds in another order."""

from __future__ import annotations

import collections
import json

import torch

from bench.harness import weights
from bench.harness.traffic import TrainFeed, batch_kinds, serve_prompts, serve_schedule
from conftest import DENSE, ROOT, SERVE, TRAIN
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

BIG = 2**31 + 12345


def test_train_feed_repeats_for_a_seed_and_differs_across_seeds():
    a, b, c = (TrainFeed(TRAIN, 256, s, "cpu") for s in (BIG, BIG, BIG + 1))
    first = [next(a) for _ in range(3)]
    assert all(torch.equal(x["tokens"], next(b)["tokens"]) for x in first)
    assert not torch.equal(first[0]["tokens"], next(c)["tokens"])
    assert not torch.equal(first[0]["tokens"], first[1]["tokens"])  # every step draws new rows
    x = first[0]
    assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert int(x["tokens"].min()) >= 0 and int(x["tokens"].max()) < 256


def test_serve_schedule_is_the_same_kinds_in_another_order():
    traffic = json.loads((ROOT / "bench" / "traffic" / "serve-longdoc-16k.json").read_text())
    cycle = len(batch_kinds(traffic))
    one, two = serve_schedule(traffic, BIG, 4 * cycle), serve_schedule(traffic, BIG + 7, 4 * cycle)
    assert one == serve_schedule(traffic, BIG, 4 * cycle) and one != two
    for k in range(4):
        assert collections.Counter(one[k * cycle:(k + 1) * cycle]) == collections.Counter(batch_kinds(traffic))
    assert {p * b for p, b in batch_kinds(traffic)} == {16384}


def test_serve_prompts_repeat_by_batch_index():
    kind = batch_kinds(SERVE)[0]
    a = serve_prompts(SERVE, 256, BIG, 3, kind, "cpu")
    assert torch.equal(a, serve_prompts(SERVE, 256, BIG, 3, kind, "cpu"))
    assert not torch.equal(a, serve_prompts(SERVE, 256, BIG, 4, kind, "cpu"))
    assert tuple(a.shape) == (kind[1], kind[0])


def test_weights_repeat_for_a_seed():
    cfg = ModelConfig(**DENSE)
    shapes = T.abstract_params(cfg)
    a, b, c = (weights.make(shapes, s, "cpu") for s in (BIG, BIG, BIG + 1))
    assert torch.equal(a["layers"][1]["attn.wq"], b["layers"][1]["attn.wq"])
    assert not torch.equal(a["layers"][1]["attn.wq"], c["layers"][1]["attn.wq"])
    assert torch.equal(a["layers"][0]["norm1.scale"], torch.ones(64))
    std = float(a["layers"][0]["mlp.wo"].float().std())
    assert abs(std * 160 ** 0.5 - 1) < 0.1
