"""Batched serving demo, the reference's ``examples/serve_decode.py`` on
the port: prefill + greedy decode with KV caches.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        --arch minicpm3-4b [--device cpu]

The architecture's reduced (smoke) configuration, as in the reference,
with the registry's weights from seed 0 on the device; prompts from
numpy seed 0; an encoder–decoder's stub-frontend frames from a
``torch.Generator`` seeded 1 (drawn on the host, so both devices see the
same frames).  On the card attention and the selective scan run their
kernels.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_arch
from ..device import resolve_device
from ..models import registry
from ..serve import ServeEngine


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_decode")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain twins)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch).smoke   # reduced config, as the reference's
    params = registry.init(cfg, seed=0, device=device)
    engine = ServeEngine(cfg=cfg, params=params,
                         max_len=args.prompt_len + args.tokens + 8)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    enc_out = None
    if cfg.family == "encdec":
        mod = registry.model_module(cfg)
        gen = torch.Generator().manual_seed(1)
        frames = torch.randn((args.batch, cfg.enc_seq, cfg.d_model),
                             generator=gen).to(device, cfg.torch_dtype)
        with torch.inference_mode():
            enc_out = mod.encode(cfg, params, frames)
    _sync(device)
    t0 = time.time()
    out = engine.generate(prompts, args.tokens, enc_out=enc_out)
    _sync(device)
    dt = time.time() - t0
    print(f"arch={cfg.name} batch={args.batch} generated "
          f"{out.shape[1]} tokens/seq in {dt:.1f}s "
          f"({args.batch * out.shape[1] / dt:.1f} tok/s)")
    print("sample:", out[0][:16])
    # decode is deterministic greedy: same prompts → same continuation
    out2 = engine.generate(prompts, args.tokens, enc_out=enc_out)
    if not np.array_equal(out, out2):
        raise AssertionError("greedy decode gave two continuations")
    print("determinism check passed")
    return out


if __name__ == "__main__":
    main()
