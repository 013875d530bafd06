"""qwen1.5-32b [hf:Qwen/Qwen1.5-0.5B card family] — dense, QKV bias (the
reference's ``repro/configs/qwen1_5_32b.py``, field for field)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab_size=152064,
    qkv_bias=True, norm="rmsnorm", act="swiglu",
    n_nodes=4,
    citation="hf:Qwen/Qwen1.5-0.5B (32B sibling card)",
)
