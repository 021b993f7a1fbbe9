"""whisper-base [audio]: 6L d_model=512 8H (GQA kv=8) d_ff=2048 vocab=51865 —
enc-dec, conv frontend (stub). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import EncDecConfig, Family, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family=Family.ENCDEC,
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    encdec=EncDecConfig(encoder_layers=6, encoder_seq=1500, frontend="stub"),
    max_seq_len=65536,
)
