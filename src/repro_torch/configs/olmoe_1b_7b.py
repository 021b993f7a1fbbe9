"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE 64e top-8. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import Family, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family=Family.MOE,
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8),
    max_seq_len=524288,
)
