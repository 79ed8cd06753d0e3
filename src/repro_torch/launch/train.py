"""Training entry point: ``python -m repro_torch.launch.train --arch <id>``.

The port of :mod:`repro.launch.train`: arch config -> model and AdamW ->
:class:`~repro_torch.train.spot_trainer.SpotTrainer` (ACC policy,
checkpointing, preemption and restore) -> :class:`~repro_torch.data.TokenStream`,
on one device: the card unless ``--device cpu``.  Archs the port lacks raise
``KeyError``, as :func:`repro_torch.configs.get_config` does.

    PYTHONPATH=src python -m repro_torch.launch.train --preset smoke --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --preset smoke --steps 20 --codec int8
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import SimParams, get_instance, synthetic_trace
from repro_torch.data import TokenStream
from repro_torch.engine.base import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.spot_trainer import SpotRunReport, SpotTrainer, SpotTrainerConfig
from repro_torch.train.steps import make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="glm4-9b", help="an arch id the port has (glm4-9b, recurrentgemma-9b, falcon-mamba-7b)")
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke",
                    help="smoke: reduced config (CPU-runnable); full: the published config, which does not fit "
                         "one H100 with AdamW (glm4-9b: 9.4 B parameters x 12 bytes of bf16 weights and grads "
                         "and float32 moments = 113 GB, against the card's 80 GB)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--a-bid", type=float, default=0.45)
    ap.add_argument("--step-time-s", type=float, default=120.0, help="virtual seconds per step")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--codec", choices=["raw", "int8"], default="raw")
    ap.add_argument("--trace-seed", type=int, default=3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None, help="torch device (default: the card; 'cpu' runs the plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> SpotRunReport:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.preset == "full" else get_smoke_config(args.arch)
    opt_cfg = AdamWConfig(lr=1e-3)
    train_step = make_train_step(cfg, opt_cfg, microbatches=args.microbatches, remat=False, q_block=128, kv_block=128)
    data = TokenStream(vocab_size=cfg.vocab_size, batch=args.batch, seq_len=args.seq, seed=11, device=device)

    def init():
        params = T.init_params(cfg, 0, device=device)
        return params, adamw_init(params, opt_cfg)

    trace = synthetic_trace(get_instance("m1.xlarge", "eu-west-1"), horizon_days=45, seed=args.trace_seed)
    tcfg = SpotTrainerConfig(
        a_bid=args.a_bid,
        ckpt_dir=args.ckpt_dir,
        max_steps=args.steps,
        step_time_s=args.step_time_s,
        sim=SimParams(),
        codec=args.codec,
        async_io=True,
    )
    trainer = SpotTrainer(tcfg, train_step=train_step, init_params=init, data=data, trace=trace)
    report = trainer.run()
    print(
        f"arch={cfg.name} device={device} steps={report.steps_done}/{args.steps} completed={report.completed}\n"
        f"virtual_time={report.virtual_time_s/3600:.2f}h cost=${report.cost:.2f} "
        f"ckpts={report.n_checkpoints} preemptions={report.n_preemptions} restores={report.n_restores}\n"
        f"loss: first={report.losses[0]:.3f} last={report.losses[-1]:.3f}"
    )
    return report


if __name__ == "__main__":
    main()
