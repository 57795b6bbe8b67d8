"""End-to-end LM training on the port: the counterpart of
``examples/train_lm.py``.  The full loop -- deterministic data, AdamW,
async atomic checkpoints, the NaN guard, the heartbeat, resume -- on a
~100M-parameter model (or a tiny preset), with the forward and backward
in bf16 over fp32 master weights.

    # tiny preset on the CPU (seconds):
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 30

    # ~100M parameters on the card, a few hundred steps:
    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m --steps 300

    # stop it at any point (SIGTERM saves a checkpoint), then resume
    # exactly with the same command.

    # an arch's smoke config instead of a preset (an audio encoder such
    # as hubert-xlarge trains on the frames stream):
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu \
        --arch hubert-xlarge --steps 10 --seq 32

It runs on the card unless ``--device cpu`` is given.
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.config import ModelConfig, count_params  # noqa: E402
from repro_torch.train.data import DataConfig  # noqa: E402
from repro_torch.train.loop import LoopConfig, TrainLoop  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

PRESETS = {
    "tiny": ModelConfig(
        name="lm-tiny", family="dense", d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=2048,
        pattern=("global",), repeats=4, remat="none"),
    "100m": ModelConfig(
        name="lm-100m", family="dense", d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=32000,
        pattern=("local", "global"), repeats=6, sliding_window=512,
        remat="none"),
}


def model_config(preset: str, arch: str | None = None) -> ModelConfig:
    """``arch``'s smoke config where an arch is named, else the preset."""
    return registry.get_smoke_config(arch) if arch else PRESETS[preset]


def build_loop(preset: str, steps: int, seq: int, batch: int,
               ckpt_dir: str, device, arch: str | None = None) -> TrainLoop:
    """The example's loop: the model (``model_config``) on ``device``, the
    LM stream -- the frames stream for an audio frontend -- at ``seq`` x
    ``batch``, checkpoints under ``ckpt_dir/<preset or arch>``."""
    cfg = model_config(preset, arch)
    kind = "frames" if cfg.frontend == "audio_frames" else "lm"
    data = DataConfig(kind=kind, vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, frontend_dim=cfg.frontend_dim)
    name = arch or preset
    return TrainLoop(
        cfg,
        OptConfig(peak_lr=3e-4, warmup_steps=20, decay_steps=steps),
        data,
        LoopConfig(total_steps=steps, ckpt_every=max(steps // 4, 10),
                   ckpt_dir=f"{ckpt_dir}/{name}", log_every=5,
                   heartbeat_path=f"{ckpt_dir}/{name}/hb.json"),
        device=device)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--arch", default=None,
                    help="train this registry arch's smoke config instead "
                         "of the preset")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_config(args.preset, args.arch)
    print(f"model {cfg.name}: {count_params(cfg)/1e6:.1f}M params, "
          f"{cfg.num_layers} layers, on {dev}")
    loop = build_loop(args.preset, args.steps, args.seq, args.batch,
                      args.ckpt_dir, dev, args.arch)
    loop.install_signal_handler()
    hist = loop.run(resume=not args.no_resume)
    if hist:
        first = sum(h["loss"] for h in hist[:5]) / min(len(hist), 5)
        last = sum(h["loss"] for h in hist[-5:]) / min(len(hist), 5)
        print(f"\nloss {first:.3f} -> {last:.3f} over {len(hist)} steps "
              f"({'improved' if last < first else 'check config'})")
    return hist


if __name__ == "__main__":
    main()
