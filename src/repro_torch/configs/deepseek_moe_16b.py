"""deepseek-moe-16b [arXiv:2401.06066] — fine-grained MoE: 2 shared + 64
routed top-6 (the reference's ``repro/configs/deepseek_moe_16b.py``, field
for field).

Assignment's d_ff=1408 is the per-expert hidden dim (moe_d_ff); the first layer is
a dense FFN with d_ff=10944 per the paper.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    n_experts=64, n_shared_experts=2, moe_top_k=6, moe_d_ff=1408,
    first_k_dense=1,
    n_nodes=8,
    citation="arXiv:2401.06066",
)
