"""deepseek-v3-671b [arXiv:2412.19437] — MLA, 1 shared + 256 routed top-8,
MTP (the reference's ``repro/configs/deepseek_v3_671b.py``, field for field).

Assignment's d_ff=2048 is the per-expert hidden dim; the first 3 layers are
dense (d_ff=18432). Parameters are bfloat16.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab_size=129280,
    n_experts=256, n_shared_experts=1, moe_top_k=8, moe_d_ff=2048,
    first_k_dense=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    use_mtp=True, mtp_coef=0.3,
    n_nodes=2, param_dtype="bfloat16",
    citation="arXiv:2412.19437",
)
