"""zamba2-7b [arXiv:2411.15242] — Mamba2 backbone + shared attention block
(the reference's ``repro/configs/zamba2_7b.py``, field for field)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_groups=1, ssm_chunk=64,
    attn_every=6,
    n_nodes=8,
    citation="arXiv:2411.15242",
)
