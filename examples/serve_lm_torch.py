"""Batched LM serving on the port: continuous batching with mixed prompt
lengths, slot refill and EOS handling, on a smoke-size model.

    PYTHONPATH=src python examples/serve_lm_torch.py --requests 12 --slots 4

The engine runs K15 (flash attention) and K16 (RMSNorm) on the card, each
decode tick one CUDA graph replay; ``--backend torch`` serves the plain
PyTorch model, and ``--device cpu`` runs the kernels' plain twins.  The
default arch is the port's LM main path, ``gemma2-9b``: the reference's
default, ``granite-3-2b``, has 8-wide heads in its smoke config, which K15
is not built for (head dims 16 to 256), so it serves with ``--backend
torch``.  ``--arch`` names any decoding arch of the registry, e.g.
``mamba2-370m`` (Mamba2/SSD), ``deepseek-v2-lite`` (MLA and MoE) or
``zamba2-1.2b`` (the hybrid); an encoder (hubert) has no decode path.
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.models.layers import BACKENDS  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b",
                    help="smoke config of this arch serves the demo")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--backend", choices=BACKENDS, default="kernels")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the kernels' plain twins")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = registry.get_smoke_config(args.arch)
    params = init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    engine = ServeEngine(params, cfg, slots=args.slots, max_len=128,
                         backend=args.backend, device=dev)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(3, 24))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        engine.submit(Request(rid=i, prompt=prompt,
                              max_new_tokens=args.max_new))

    t0 = time.time()
    done = engine.run()
    dt = time.time() - t0
    toks = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) using {engine.ticks} engine ticks "
          f"on {args.slots} slots ({args.backend} backend on {dev}; ticks "
          f"{dict(engine.tick_kinds)})")
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.output}")


if __name__ == "__main__":
    main()
