"""The transformer family, dense or mixture-of-experts, as the plain
reference and the frozen counts read a configuration file whose
``reference`` is ``transformer``: its sizes, the parameter tree (its keys
are the port's, so that one x^0 can be handed to both sides), each leaf's
init scale, the model FLOPs per token and the plain model itself.

Model semantics (the port's, which follow its JAX reference): the residual
stream, RMSNorm or LayerNorm, rotary embedding on the first
``partial_rotary_factor`` of each head with interleaved pairs (2i, 2i+1),
causal softmax attention, SwiGLU MLPs; a MoE layer routes each token by a
float32 softmax router to its top-k experts (ties to the lower index),
renormalizes the k gates, queues the choices token by token and drops a
choice past its expert's capacity ``max(8, ceil8(ceil(T k cf / E)))``,
adds the shared experts, and adds ``aux_coef * E * sum_e f_e P_e`` to the
loss. The loss is the mean next-token cross-entropy over every token.

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 with a per-tensor scale (the router stays float32, as the
configuration keeps it), all else as above.

Imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from harness.reference import fp8

Shape = Tuple[int, ...]
Tree = Dict[str, Any]
DENSE_BLOCK_TOKENS = 2048     # tokens per backward of a dense batch


@dataclasses.dataclass(frozen=True)
class Sizes:
    family: str                 # dense | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    norm: str                   # rmsnorm | layernorm
    eps: float
    rope_pct: float
    rope_theta: float
    n_experts: int = 0
    n_shared: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense: int = 0
    capacity_factor: float = 1.25
    aux_coef: float = 0.0
    qkv_bias: bool = False
    tie: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def segments(self) -> List[Tuple[str, int]]:
        if self.family == "moe":
            segs = [("dense", self.first_dense)] if self.first_dense else []
            return segs + [("moe", self.n_layers - self.first_dense)]
        return [("dense", self.n_layers)]

    def param_shapes(self) -> Tree:
        """The parameter tree as nested dicts of shapes; a segment's blocks
        are stacked on a leading layer axis."""
        d, hd = self.d_model, self.head_dim
        tree: Tree = {"embed": {"embedding": (self.vocab, d)},
                      "final_norm": self._norm(())}
        if not self.tie:
            tree["embed"]["lm_head"] = (d, self.vocab)
        for si, (kind, n) in enumerate(self.segments()):
            L = (n,)
            q, kv = self.n_heads * hd, self.n_kv_heads * hd
            attn = {"wq": L + (d, q), "wk": L + (d, kv), "wv": L + (d, kv),
                    "wo": L + (q, d)}
            if self.qkv_bias:
                attn.update(bq=L + (q,), bk=L + (kv,), bv=L + (kv,))
            seg: Tree = {"attn": attn, "norm1": self._norm(L),
                         "norm2": self._norm(L)}
            if kind == "moe":
                e, f = self.n_experts, self.moe_d_ff
                moe = {"router": L + (d, e), "w_gate": L + (e, d, f),
                       "w_in": L + (e, d, f), "w_out": L + (e, f, d)}
                if self.n_shared:
                    fs = f * self.n_shared
                    moe.update(shared_gate=L + (d, fs), shared_in=L + (d, fs),
                               shared_out=L + (fs, d))
                seg["moe"] = moe
            else:
                seg["mlp"] = {"w_gate": L + (d, self.d_ff),
                              "w_in": L + (d, self.d_ff),
                              "w_out": L + (self.d_ff, d)}
            tree[f"seg{si}"] = seg
        return tree

    def _norm(self, lead: Shape) -> Dict[str, Shape]:
        out = {"scale": lead + (self.d_model,)}
        if self.norm == "layernorm":
            out["bias"] = lead + (self.d_model,)
        return out

    def init_scale(self, path: Tuple[str, ...]) -> float:
        """The truncated-normal scale of a drawn leaf: output projections at
        0.02 / sqrt(2 L), every other matrix at 0.02; 1.0 marks a norm
        scale and 0.0 a bias (constants, not drawn)."""
        name = path[-1]
        if name == "scale":
            return 1.0
        if name in ("bias", "bq", "bk", "bv"):
            return 0.0
        if name == "wo" or (path[-2] == "moe" and name in ("w_out",
                                                           "shared_out")):
            return 0.02 / math.sqrt(2 * self.n_layers)
        return 0.02

    def active_matmul_params(self) -> Dict[str, int]:
        """Matmul parameters one token passes through, by part: the LM
        head, and per layer the attention projections and the MLP, or the
        router, the routed experts it is sent to and the shared experts.
        Embedding lookups, norms and biases are no matmuls."""
        d, hd = self.d_model, self.head_dim
        attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        out = {"head": d * self.vocab}
        for si, (kind, n) in enumerate(self.segments()):
            if kind == "moe":
                experts = (self.top_k + self.n_shared) * 3 * d * self.moe_d_ff
                out[f"seg{si}"] = n * (attn + d * self.n_experts + experts)
            else:
                out[f"seg{si}"] = n * (attn + 3 * d * self.d_ff)
        return out

    def flops_per_token(self, seq_len: int) -> int:
        """Model FLOPs of one token's forward and backward: 6 x the active
        matmul parameters plus 12 L S d_model for attention's scores and
        values. No recomputation, padding or capacity slack counts."""
        params = sum(self.active_matmul_params().values())
        return 6 * params + 12 * self.n_layers * seq_len * self.d_model

    def rows_per_backward(self, rows: int, seq_len: int) -> int:
        """Rows of a node's batch taken in one backward: a MoE batch routes
        as one, a dense one runs in blocks of rows."""
        if self.family == "moe":
            return rows
        return max(1, DENSE_BLOCK_TOKENS // seq_len)

    def model(self, precision: str = "float32") -> "Model":
        return Model(self, precision)


def sizes(config: Dict[str, Any]) -> Sizes:
    """The sizes of a configuration file (its semantics the port's own keys
    under ``port.set`` give where the published file names none)."""
    run = config["port"]["set"]
    moe = "n_routed_experts" in config
    eps = config.get("rms_norm_eps", config.get("layer_norm_eps"))
    return Sizes(
        family="moe" if moe else "dense",
        n_layers=int(config["num_hidden_layers"]),
        d_model=int(config["hidden_size"]),
        n_heads=int(config["num_attention_heads"]),
        n_kv_heads=int(config["num_key_value_heads"]),
        d_ff=int(config["intermediate_size"]),
        vocab=int(config["vocab_size"]),
        norm=run["norm"], eps=float(eps),
        rope_pct=float(config.get("partial_rotary_factor",
                                  run.get("rope_pct", 1.0))),
        rope_theta=float(config["rope_theta"]),
        n_experts=int(config.get("n_routed_experts", 0)),
        n_shared=int(config.get("n_shared_experts", 0)),
        top_k=int(config.get("num_experts_per_tok", 0)),
        moe_d_ff=int(config.get("moe_intermediate_size", 0)),
        first_dense=int(config.get("first_k_dense_replace", 0)),
        capacity_factor=float(run.get("capacity_factor", 1.25)),
        aux_coef=float(config.get("aux_loss_alpha", 0.0)),
        qkv_bias=bool(config.get("use_qkv_bias",
                                 config.get("attention_bias", False))),
        tie=bool(config["tie_word_embeddings"]))


class Model:
    """The configuration's forward and loss over a parameter tree whose
    stacked leaves are given layer by layer (``seg{i}`` a list of
    per-layer trees)."""

    def __init__(self, s: Sizes, precision: str = "float32") -> None:
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.s = s
        self.low = precision == "fp8"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.low:
            a, b = fp8(a), fp8(b)
        return a @ b

    def norm(self, p: Tree, x: torch.Tensor) -> torch.Tensor:
        if self.s.norm == "layernorm":
            mu = x.mean(-1, keepdim=True)
            var = ((x - mu) ** 2).mean(-1, keepdim=True)
            return (x - mu) * torch.rsqrt(var + self.s.eps) * p["scale"] \
                + p["bias"]
        ms = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(ms + self.s.eps) * p["scale"]

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, H, hd); pairs (2i, 2i+1) of the first ``rot`` lanes
        rotate by position * theta^(-2i/rot)."""
        hd, seq = x.shape[-1], x.shape[1]
        rot = int(hd * self.s.rope_pct)
        rot -= rot % 2
        if rot == 0:
            return x
        exps = torch.arange(0, rot, 2, dtype=torch.float32,
                            device=x.device) / rot
        inv = 1.0 / (self.s.rope_theta ** exps)
        pos = torch.arange(seq, dtype=torch.float32, device=x.device)
        ang = pos[:, None] * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
        yr = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return torch.cat([yr.reshape(x[..., :rot].shape), x[..., rot:]], -1)

    def attention(self, p: Tree, h: torch.Tensor) -> torch.Tensor:
        s = self.s
        b, seq, _ = h.shape
        hd = s.head_dim

        def proj(w: str, bias: str, heads: int) -> torch.Tensor:
            y = self.mm(h, p[w])
            if s.qkv_bias:
                y = y + p[bias]
            return y.reshape(b, seq, heads, hd)
        q = self.rope(proj("wq", "bq", s.n_heads))
        k = self.rope(proj("wk", "bk", s.n_kv_heads))
        v = proj("wv", "bv", s.n_kv_heads)
        g = s.n_heads // s.n_kv_heads
        k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
        if self.low:
            q, k, v = fp8(q), fp8(k), fp8(v)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        causal = torch.ones(seq, seq, dtype=torch.bool,
                            device=h.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        if self.low:
            probs = fp8(probs)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.mm(out.reshape(b, seq, s.n_heads * hd), p["wo"])

    def mlp(self, p: Tree, h: torch.Tensor) -> torch.Tensor:
        return self.mm(F.silu(self.mm(h, p["w_gate"])) * self.mm(h, p["w_in"]),
                       p["w_out"])

    def capacity(self, tokens: int) -> int:
        s = self.s
        cap = int(math.ceil(tokens * s.top_k * s.capacity_factor
                            / s.n_experts))
        return max(8, -(-cap // 8) * 8)

    def moe(self, p: Tree, h: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self.s
        b, seq, d = h.shape
        e, k = s.n_experts, s.top_k
        x = h.reshape(b * seq, d)
        probs = torch.softmax(x @ p["router"], dim=-1)             # (T, E)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates = top.values[:, :k]
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        chosen = top.indices[:, :k]                                # (T, k)
        counts = F.one_hot(chosen, e).to(torch.float32).sum(1)     # (T, E)
        aux = e * torch.sum(counts.mean(0) * probs.mean(0))
        # each choice's place in its expert's queue, token by token
        flat = chosen.reshape(-1)
        onehot = F.one_hot(flat, e)
        place = (torch.cumsum(onehot, 0) - 1).gather(1, flat[:, None])[:, 0]
        kept = place < self.capacity(b * seq)
        flat_gates = gates.reshape(-1)
        y = torch.zeros_like(x)
        for ex in range(e):
            sel = torch.nonzero((flat == ex) & kept)[:, 0]
            if sel.numel() == 0:
                continue
            tok = sel // k
            xe = x[tok]
            ye = self.mm(F.silu(self.mm(xe, p["w_gate"][ex]))
                         * self.mm(xe, p["w_in"][ex]), p["w_out"][ex])
            y = y.index_add(0, tok, ye * flat_gates[sel][:, None])
        if s.n_shared:
            y = y + self.mm(F.silu(self.mm(x, p["shared_gate"]))
                            * self.mm(x, p["shared_in"]), p["shared_out"])
        return y.reshape(b, seq, d), aux

    def loss_sum(self, params: Tree, tokens: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        """Sum of the token cross-entropies, plus ``aux_coef`` times the MoE
        layers' aux loss times the token count (so that the sum over the
        batch, divided by its tokens, is the loss)."""
        s = self.s
        x = params["embed"]["embedding"][tokens]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for si, (kind, _) in enumerate(s.segments()):
            for bp in params[f"seg{si}"]:
                x = x + self.attention(bp["attn"], self.norm(bp["norm1"], x))
                h = self.norm(bp["norm2"], x)
                if kind == "moe":
                    y, a = self.moe(bp["moe"], h)
                    x, aux = x + y, aux + a
                else:
                    x = x + self.mlp(bp["mlp"], h)
        h = self.norm(params["final_norm"], x)
        head = (params["embed"]["embedding"].T if s.tie
                else params["embed"]["lm_head"])
        logits = self.mm(h, head)
        ce = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, labels[..., None])[..., 0]
        return ce.sum() + s.aux_coef * aux * labels.numel()
