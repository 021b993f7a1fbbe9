"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual. [hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import Family, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family=Family.MOE,
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual_ff=4864),
    max_seq_len=524288,
)
