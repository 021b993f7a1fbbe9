"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
— InternViT (stub frontend) + InternLM2 backbone. [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import Family, ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family=Family.VLM,
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    vlm=VLMConfig(num_patches=1024, frontend="stub"),
    max_seq_len=65536,
)
