"""Serving launcher (static mode): one Engine batch under a quantization
mode, with an optional CushionCache prefix, on the card unless
``--device cpu``.

    python -m repro_torch.launch.serve --arch smollm-360m --quant pt_static \
        --prequant --kv-dtype int8 --cushion-len 4

Weights are random, made from ``--seed``. The cushion is ``extract_cushion``
of ``--cushion-len`` token ids drawn from the seed; pt_static calibrates its
site scales at engine load over two pipeline batches, under the cushion.
Prompts and calibration batches are the same token ids as the JAX
launcher's (``data/pipeline.py`` is a copy). Loading a tuned cushion
artifact (``--cushion DIR``) is not ported yet.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch.configs import QuantConfig, get_config
from repro_torch.data.pipeline import Pipeline, SyntheticCorpus
from repro_torch.models.registry import build
from repro_torch.serving.engine import Engine

CALIB_BATCHES = 2


def seeded_cushion(api, params, m: int, seed: int):
    """The cushion of ``m`` seeded token ids, extracted in fp."""
    ids = np.random.RandomState(seed).randint(0, api.cfg.vocab_size, m)
    return api.extract_cushion(params, torch.as_tensor(ids, dtype=torch.int32),
                               None, QuantConfig())


def to_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _append_point(path: str, point: dict) -> None:
    hist = []
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        hist = prev if isinstance(prev, list) else [prev]
    hist.append(point)
    with open(path, "w") as f:
        json.dump(hist, f, indent=1)
    print(f"[serve] bench point -> {path}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_tiny")
    ap.add_argument("--quant", default="none",
                    choices=["none", "pt_static", "pt_dynamic",
                             "ptoken_dynamic"])
    ap.add_argument("--prequant", action="store_true",
                    help="int8-resident weights (requires --quant pt_static)")
    ap.add_argument("--kv-dtype", default="fp", choices=["fp", "int8"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--cushion-len", type=int, default=0,
                    help="cushion prefix length m (0: no cushion)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--bench-json", default=None,
                    help="append a trajectory point to this file")
    args = ap.parse_args(argv)
    if args.prequant and args.quant != "pt_static":
        ap.error("--prequant requires --quant pt_static")

    cfg = get_config(args.arch)
    api = build(cfg, args.device)
    dev = api.device
    params = api.init_params(torch.Generator(dev).manual_seed(args.seed))
    qcfg = QuantConfig(mode=args.quant, true_int8=args.quant == "pt_static")
    cushion = None
    if args.cushion_len:
        cushion = seeded_cushion(api, params, args.cushion_len, args.seed)

    corpus = SyntheticCorpus(cfg.vocab_size, seed=args.seed)
    pipe = Pipeline(corpus, batch=args.batch, seq_len=args.prompt_len,
                    seed=args.seed + 1)
    calib = None
    if args.quant == "pt_static":
        calib = [to_device(pipe.get_batch(1000 + i), dev)
                 for i in range(CALIB_BATCHES)]
    batch = to_device(pipe.get_batch(0), dev)
    eng = Engine(api, params, qcfg, max_seq=args.prompt_len + args.tokens + 32,
                 cushion=cushion,
                 kv_dtype=None if args.kv_dtype == "fp" else args.kv_dtype,
                 calib_batches=calib, prequant=args.prequant)
    print(f"[serve] device={dev} "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
          f" resident weights: fp={eng.weight_bytes_fp / 2 ** 20:.1f} MiB "
          f"int8={eng.weight_bytes_int8 / 2 ** 20:.1f} MiB")
    if args.bench_json:
        eng.generate(batch, args.tokens)     # warm-up: allocator, build
    res = eng.generate(batch, args.tokens)
    print(f"[serve] B={args.batch} prompt={args.prompt_len} "
          f"gen={args.tokens} kv={args.kv_dtype} m={eng.prefix_len} "
          f"TTFT={res.ttft_ms:.1f}ms TPOT={res.tpot_ms:.2f}ms")
    print("[serve] sample:", res.tokens[0][:16].tolist())
    if args.bench_json:
        _append_point(args.bench_json, {
            "mode": "static", "arch": args.arch, "quant": args.quant,
            "prequant": args.prequant, "kv_dtype": args.kv_dtype,
            "cushion_len": args.cushion_len, "batch": args.batch,
            "prompt_len": args.prompt_len, "tokens": args.tokens,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "weight_bytes_fp": eng.weight_bytes_fp,
            "weight_bytes_int8": eng.weight_bytes_int8,
            "ttft_ms": res.ttft_ms, "tpot_ms": res.tpot_ms})
    return res


if __name__ == "__main__":
    main()
