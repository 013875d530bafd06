"""Model configuration (counterpart of ``repro/models/config.py``).

Re-declared here because importing ``repro.models.config`` runs
``repro/models/__init__.py``, which imports jax. The fields, defaults and
``reduced()`` are the reference's, so a configuration means the same thing
in both packages; so are the serve workloads' ``InputShape`` and
``INPUT_SHAPES``. ``PORT_ONLY`` lists the fields the reference lacks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | ssm | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # dense-transformer details
    qkv_bias: bool = False           # qwen1.5
    qk_norm: bool = False            # chameleon
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5           # deepseek-moe-16b publishes 1e-6
    act: str = "swiglu"              # swiglu | gelu | relu2 (minitron/nemotron)
    rope_pct: float = 1.0            # stablelm-2 uses 0.25
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # SWA variant (long_500k on dense archs)

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (fine-grained)
    first_k_dense: int = 0           # leading dense-FFN layers (deepseek)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # hybrid (zamba2): shared attention block applied every `attn_every` layers
    attn_every: int = 0

    # MLA (deepseek-v3)
    use_mla: bool = False
    q_lora_rank: int = 0             # 0 -> full-rank q projection
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # MTP (deepseek-v3 multi-token prediction)
    use_mtp: bool = False
    mtp_coef: float = 0.3

    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # beyond-paper perf knobs (EXPERIMENTS.md §Perf)
    causal_parts: int = 1     # >1: split prefill queries into P parts, each
                              # attending only its kv prefix (~2x fewer flops)
    batch_axes: Optional[Tuple[str, ...]] = None
    expert_axis: Optional[str] = None
    # mesh axis to pin MoE dispatch buffers' expert dim to (keeps the
    # dispatch gather expert-local instead of replicating (E*cap, D) tensors
    # on every model shard; §Perf dsv3 iteration)
    moe_route_blocks: int = 1
    # >1: route tokens in independent blocks (capacity per block). Aligning
    # blocks with the fsdp token sharding keeps the router's cumsum/one-hot
    # shard-LOCAL (a global cumsum over 512k tokens forces GSPMD to
    # replicate); standard local-dispatch semantics in production MoEs.
    # mesh axes to pin the activations' batch dim to, right after the token/
    # frontend embedding. Without this, GSPMD's "involuntary full
    # rematerialization" of the embedding gather REPLICATES activations over
    # the data axis and the whole serve forward runs redundantly on every
    # data shard (§Perf iter: 16x compute + collective blowup).

    # decentralized (SPARQ) layout: nodes on the single-pod production mesh;
    # multi-pod either doubles nodes (pod_axis_to="node") or doubles fsdp.
    n_nodes: int = 16
    pod_axis_to: str = "node"        # node | fsdp
    remat: bool = True

    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                vocab: int = 512, n_experts: Optional[int] = None) -> "ModelConfig":
        """Reduced variant of the same family for CPU smoke tests."""
        d_model = min(self.d_model, d_model)
        heads = max(1, min(self.n_heads, d_model // 64))
        kv = max(1, min(self.n_kv_heads, heads))
        ne = self.n_experts
        if ne:
            ne = min(ne, 4 if n_experts is None else n_experts)
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, n_layers),
            d_model=d_model,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=None,
            d_ff=max(64, min(self.d_ff, d_model * 3)),
            vocab_size=min(self.vocab_size, vocab),
            n_experts=ne,
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            first_k_dense=min(self.first_k_dense, 1),
            q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
            kv_lora_rank=min(self.kv_lora_rank, 64),
            qk_rope_dim=min(self.qk_rope_dim, 16),
            qk_nope_dim=min(self.qk_nope_dim, 32),
            v_head_dim=min(self.v_head_dim, 32),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32),
            ssm_chunk=min(self.ssm_chunk, 16),
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            n_nodes=4,
            remat=False,
        )


# fields the reference's ModelConfig lacks, with the value that means what
# the reference does (its norms take 1e-5)
PORT_ONLY = {"norm_eps": 1e-5}


def reference_fields(cfg: ModelConfig) -> dict:
    """``cfg``'s fields as the reference's ``ModelConfig`` has them: each
    of ``PORT_ONLY`` left out where it holds the reference's value (one
    the reference cannot express stays, so the two never compare equal)."""
    d = dataclasses.asdict(cfg)
    for k, v in PORT_ONLY.items():
        if d[k] == v:
            del d[k]
    return d


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
