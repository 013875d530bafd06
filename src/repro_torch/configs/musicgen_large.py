"""musicgen-large [arXiv:2306.05284] — decoder-only over EnCodec tokens (the
reference's ``repro/configs/musicgen_large.py``, field for field).

The EnCodec codec frontend is a stub in both packages: precomputed frame
embeddings (B, S, d_model) enter ``forward_hidden(embeds=...)``; the backbone
below is the full language model over codec tokens (vocab 2048). GELU MLP +
LayerNorm per MusicGen.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    norm="layernorm", act="gelu",
    n_nodes=8,
    citation="arXiv:2306.05284",
)
