"""Quantized serving with a CushionCache on the PyTorch port: batched
prefill + decode under each quantization mode, the paper's deployment
(per-tensor static W8A8, int8-resident weights, an int8 KV cache with the
cushion kept in fp) last, with TTFT / TPOT. On the card unless ``--device
cpu``.

    PYTHONPATH=src python examples/torch_quantized_serving.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import QuantConfig, get_config
from repro_torch.core.calibration import calibrate
from repro_torch.data.pipeline import Pipeline, SyntheticCorpus
from repro_torch.launch.serve import to_device
from repro_torch.models.registry import build
from repro_torch.serving.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tokens", type=int, default=24)
    args = ap.parse_args(argv)
    cfg = get_config("paper_tiny")
    api = build(cfg, args.device)
    dev = api.device
    params = api.init_params(torch.Generator(dev).manual_seed(0))
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    pipe = Pipeline(corpus, batch=4, seq_len=64, seed=0)
    batch = to_device(pipe.get_batch(0), dev)
    calb = [to_device(pipe.get_batch(100 + i), dev) for i in range(2)]

    # a cushion straight from nonsemantic tokens (a stand-in for the
    # greedy search's output)
    cushion = api.extract_cushion(params, torch.tensor([1, 2, 3],
                                                       dtype=torch.int32),
                                  None, QuantConfig(mode="none"))

    print(f"{'mode':40s} {'TTFT ms':>10s} {'TPOT ms':>10s}")
    for mode, prequant, kv in (("none", False, None),
                               ("ptoken_dynamic", False, None),
                               ("pt_dynamic", False, None),
                               ("pt_static", False, None),
                               ("pt_static", True, "int8")):
        qcfg = QuantConfig(mode=mode, true_int8=mode == "pt_static")
        scales = None
        if mode == "pt_static":
            scales, _ = calibrate(api, params, calb, qcfg, cushion=cushion)
        eng = Engine(api, params, qcfg, cushion=cushion, scales=scales,
                     max_seq=160, prequant=prequant, kv_dtype=kv)
        eng.generate(batch, 8)               # warm-up: allocator, build
        res = eng.generate(batch, args.tokens)
        label = mode + ("+int8 weights+int8 KV" if prequant else "")
        print(f"{label + '+cushion':40s} {res.ttft_ms:10.1f} "
              f"{res.tpot_ms:10.2f}")


if __name__ == "__main__":
    main()
