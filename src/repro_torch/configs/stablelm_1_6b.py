"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b] — dense, LayerNorm, 25%
rotary (the reference's ``repro/configs/stablelm_1_6b.py``, field for
field)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab_size=100352,
    norm="layernorm", act="swiglu", rope_pct=0.25,
    n_nodes=16,
    citation="hf:stabilityai/stablelm-2-1_6b",
)
