"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import Family, HybridConfig, ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family=Family.HYBRID,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    hybrid=HybridConfig(period=8, attn_at=(3,), moe_every=2, moe_offset=1),
    max_seq_len=524288,
)
