"""mamba2-370m [arXiv:2405.21060] — attention-free SSD (state-space duality)
(the reference's ``repro/configs/mamba2_370m.py``, field for field)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1, ssm_chunk=64,
    n_nodes=16,
    citation="arXiv:2405.21060",
)
