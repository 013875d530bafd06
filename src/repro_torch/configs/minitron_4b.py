"""minitron-4b [arXiv:2407.14679] — pruned nemotron: squared-ReLU MLP,
LayerNorm (the reference's ``repro/configs/minitron_4b.py``, field for
field)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab_size=256000,
    norm="layernorm", act="relu2", rope_pct=0.5,
    n_nodes=8,
    citation="arXiv:2407.14679",
)
