"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152 —
llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import Family, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family=Family.DENSE,
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    max_seq_len=65536,
)
