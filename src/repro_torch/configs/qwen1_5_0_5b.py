"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B] — dense, QKV bias (the reference's
``repro/configs/qwen1_5_0_5b.py``, field for field)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=151936,
    qkv_bias=True, norm="rmsnorm", act="swiglu",
    n_nodes=16,
    citation="hf:Qwen/Qwen1.5-0.5B",
)
