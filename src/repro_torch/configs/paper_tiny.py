"""paper_tiny: a paper-faithful llama-style tiny LM (~10M params) used to
validate the paper's claims end-to-end on CPU (train -> calibrate -> greedy
search -> prefix tune -> quantized eval)."""
from repro_torch.configs.base import Family, ModelConfig

CONFIG = ModelConfig(
    name="paper_tiny",
    family=Family.DENSE,
    n_layers=4,
    d_model=256,
    n_heads=8,
    n_kv_heads=4,
    d_head=32,
    d_ff=768,
    vocab_size=512,
    max_seq_len=1024,
    qkv_bias=True,   # needed by the outlier-planting surgery (query bias
                     # gives all queries a consistent sink-seeking direction)
    dtype="float32",
)
