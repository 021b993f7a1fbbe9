"""Every architecture of the PyTorch port, one reduced-config train step's
loss and one decode step through the serving path: the uniform model API
across the six families. On the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_multiarch_smoke.py [--arch <id>] \
        [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import ARCH_IDS, QuantConfig, get_config, reduced
from repro_torch.models.registry import build


@torch.no_grad()
def smoke(arch: str, device: str) -> tuple:
    """(loss, the decode step's logits shape, parameter count) of the
    reduced ``arch`` on ``device``."""
    qn = QuantConfig(mode="none")
    cfg = reduced(get_config(arch), dtype="float32")
    api = build(cfg, device)
    params = api.init_params(torch.Generator(api.device).manual_seed(0))
    batch = api.make_batch(torch.Generator().manual_seed(0), 2, 32)
    loss, _ = api.loss_fn(params, batch, qn)
    # the serving path: a prefill of 8 tokens, then one decode step
    cache = api.init_cache(2, 64)
    pre = {k: v for k, v in batch.items() if k != "labels"}
    pre["tokens"] = batch["tokens"][:, :8]
    logits, cache, pos = api.prefill(params, pre, cache, qn)
    tok = torch.argmax(logits.reshape(2, -1), dim=-1).to(torch.int32)
    logits, cache = api.decode_step(params, tok, pos, cache, qn)
    n = sum(t.numel() for t in params.buffers())
    return float(loss), tuple(logits.shape), n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    for arch in [args.arch] if args.arch else ARCH_IDS:
        t0 = time.time()
        loss, shape, n = smoke(arch, args.device)
        print(f"{arch:16s} loss={loss:6.3f} params={n:>9,} "
              f"decode_logits={shape} ({time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main()
