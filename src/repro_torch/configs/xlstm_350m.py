"""xlstm-350m [ssm]: 24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import Family, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family=Family.SSM,
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm=SSMConfig(kind="mlstm", expand=2, mlstm_every=2),
    max_seq_len=524288,
)
