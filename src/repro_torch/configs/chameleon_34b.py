"""chameleon-34b [arXiv:2405.09818] — early-fusion VLM, VQ image tokens,
qk-norm (the reference's ``repro/configs/chameleon_34b.py``, field for
field).

Early fusion is token-level (text + VQ image ids share the 65536 vocab); the
VQ tokenizer frontend is a stub in both packages: precomputed patch-token
embeddings enter ``forward_hidden(embeds=...)``. Weights are stored in
bfloat16 (``param_dtype``).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536,
    qk_norm=True, norm="rmsnorm", act="swiglu",
    n_nodes=4, param_dtype="bfloat16",
    citation="arXiv:2405.09818",
)
