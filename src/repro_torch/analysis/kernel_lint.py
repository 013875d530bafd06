"""Kernel-contract lint of the hand-written CUDA kernels, K1 and K3, and
the dense-gossip tripwire K4 (counterpart of
``repro/analysis/kernel_lint.py``).

The reference captures each ``pallas_call``'s grid and BlockSpecs and checks
them abstractly. A CUDA kernel has no BlockSpec: its coverage is the
grid-stride loop over tiles, and its budget is what ``nvcc`` gave it. So each
rule has a leg that reads the source on the CPU and a leg that asks the card.

* **K1, source leg.** Every ``__global__`` function of ``kernels/csrc/*.cu``
  is registered to a :class:`Probe`, every ``extern "C"`` launch entry
  belongs to a probe's ``ENTRIES`` and exports ``<entry>_launch_config`` and
  ``<entry>_attributes``, and the wrapper refuses anything but a ``(tiles,
  1024)`` view (``kernels/ops.py`` pads the tail), or rows of whole tiles
  (``xhat_mix``), or anything but int64 ids of at most 8 choices a token
  (``moe_route``). An unregistered kernel is an error, as an un-probed
  ``pallas_call`` is (``kernel_lint.py:312``).
* **K1, card leg.** Each probe and dtype launches, through the C entry, on
  ``1``, ``warps - 1``, ``grid_cap * warps + 1`` and ``3 * grid_cap * warps +
  5`` tiles (``warps`` tiles per block, ``grid_cap`` the largest grid, both
  from ``_launch_config``): the outputs are filled with NaN first and the
  views stop one guard tile short of their allocation. Every tile must be
  written, the guard tile left alone, and the output must equal the plain
  version (:mod:`repro_torch.kernels.parity`'s tolerances). ``xhat_mix``
  updates its rows in place, at n = 2, 3, 4 and 16 rows of that many tiles
  and a row stride one guard tile longer: the rows must equal the plain
  version's and every guard tile keep its NaN. ``moe_route`` walks choices,
  not tiles: both entries on 1, 31 and ``CHUNK + 1`` choices and on three
  groups of three blocks in one launch (:data:`MOE_ROUTE_PROBES`), every
  output filled with a sentinel and one guard element past it; every
  element must be written, every guard left alone, the block counts equal
  the plain counts of each block's chunk and the tables the plain
  version's, bit for bit.
* **K3, closed form.** From the source's constants: the kernel's static
  shared memory must fit the 48 KiB a block gets without opting in, the
  launch passes no dynamic shared memory, and ``__launch_bounds__(threads,
  min_blocks)`` caps the registers at ``65,536 / (threads * min_blocks)``.
* **K3, card leg.** ``cudaFuncGetAttributes`` must agree with the closed
  form (static shared memory equal, registers within the cap), the
  occupancy must reach ``min_blocks``, and local memory (a spill) is a
  warning with its byte count.

Launches made here bypass the wrappers, so the wrappers' launch counts stay
those of the paths they serve.

* **K4** (:func:`lint_dense_gossip`) reads the package's Python sources:
  the dense ``(n, n)`` and ``(R, n, n)`` mixing work reachable from the flat
  engine, each site a warning with its O(n^2) ceiling.
"""
from __future__ import annotations

import ast
import dataclasses
import math
import operator
import re
import types
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import kernels
from repro_torch.analysis.rules import WARNING, Finding, finding
from repro_torch.kernels import moe_route, parity, qsgd, sign_topk, xhat_mix

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"
STATIC_SHARED_LIMIT = 48 * 1024     # per block without an opt-in
REGISTERS_PER_SM = 65536
MAX_REGISTERS_PER_THREAD = 255
K_B = 103                           # ceil(0.1 * 1024): the main path's


@dataclasses.dataclass(frozen=True)
class Probe:
    """A kernel of ``csrc/<source>.cu`` and its wrapper module (which holds
    ``ENTRIES``, ``entry``, ``launch_config`` and ``attributes``)."""

    source: str
    kernel: str          # the __global__ function
    wrapper: types.ModuleType
    refuses: Callable[[torch.Tensor], None]  # the wrapper's shape assert


PROBES: Tuple[Probe, ...] = (
    Probe("sign_topk", "sign_topk_kernel", sign_topk,
          lambda x: sign_topk._check_cuda_inputs(x, None, K_B)),
    Probe("qsgd", "qsgd_kernel", qsgd,
          lambda x: qsgd._check(x, torch.zeros_like(x), 16)),
    Probe("xhat_mix", "xhat_mix_kernel", xhat_mix,
          lambda x: xhat_mix._check(x, x.clone(), x.clone(),
                                    torch.ones(x.shape[0]), None,
                                    (1.0, ()))),
    Probe("moe_route", "moe_route_kernel", moe_route,
          lambda x: moe_route._check(x, 64, 8, None)),
)


# --------------------------------------------------------------- source scan

_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.Div: operator.floordiv, ast.FloorDiv: operator.floordiv,
        ast.Mod: operator.mod, ast.LShift: operator.lshift}


def _eval(expr: str, consts: Dict[str, int]) -> int:
    """An integer C constant expression over ``consts`` (+ - * / % <<,
    parentheses, integer literals with C suffixes)."""
    expr = re.sub(r"\b(0[xX][0-9a-fA-F]+|\d+)[uUlL]*\b", r"\1", expr)

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name):
            return consts[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](ev(node.left), ev(node.right))
        raise ValueError(f"not a constant expression: {expr!r}")
    return int(ev(ast.parse(expr.strip(), mode="eval")))


_TYPE_BYTES = {"char": 1, "unsigned char": 1, "short": 2, "int": 4,
               "unsigned": 4, "unsigned int": 4, "float": 4, "uint32_t": 4,
               "int32_t": 4, "long long": 8, "unsigned long long": 8,
               "double": 8, "uint64_t": 8, "__nv_bfloat16": 2, "half": 2,
               "float4": 16, "uint4": 16}


@dataclasses.dataclass
class Kernel:
    name: str
    line: int
    threads: Optional[int]       # __launch_bounds__' first argument
    min_blocks: Optional[int]    # its second, when given
    static_shared: int           # bytes of __shared__ arrays in the body
    dynamic_shared: Optional[int]  # the launch's third argument, if found


@dataclasses.dataclass
class Source:
    path: Path
    consts: Dict[str, int]
    kernels: Dict[str, Kernel]
    entries: Dict[str, int]      # extern "C" int functions -> line


def _body(text: str, start: int) -> str:
    """The brace-balanced body that opens at or after ``start``."""
    i = text.index("{", start)
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    raise ValueError("unbalanced braces")


def scan(path: Path) -> Source:
    """Constants, ``__global__`` kernels and ``extern "C"`` entries of one
    CUDA source."""
    text = Path(path).read_text()
    code = re.sub(r"//[^\n]*", "", text)
    consts: Dict[str, int] = {}
    for m in re.finditer(r"constexpr\s+(?:unsigned|int|long long|size_t)"
                         r"\s+(\w+)\s*=\s*([^;]+);", code):
        try:
            consts[m.group(1)] = _eval(m.group(2), consts)
        except (ValueError, KeyError, SyntaxError):
            pass          # a constant the closed form does not need

    def line(pos: int) -> int:
        return code.count("\n", 0, pos) + 1

    kernels: Dict[str, Kernel] = {}
    for m in re.finditer(r"__global__\s+void\s*(?:__launch_bounds__\s*\("
                         r"([^)]*)\)\s*)?(\w+)\s*\(", code):
        bounds, name = m.group(1), m.group(2)
        threads = min_blocks = None
        if bounds:
            args = [a.strip() for a in bounds.split(",")]
            threads = _eval(args[0], consts)
            if len(args) > 1:
                min_blocks = _eval(args[1], consts)
        shared = 0
        for s in re.finditer(r"(?<!extern )__shared__\s+(?:__align__\(\d+\)"
                             r"\s*)?([A-Za-z_][\w ]*?)\s+(\w+)\s*"
                             r"((?:\[[^\]]+\])+)\s*;", _body(code, m.end())):
            dims = re.findall(r"\[([^\]]+)\]", s.group(3))
            shared += _TYPE_BYTES[s.group(1).strip()] * math.prod(
                _eval(dim, consts) for dim in dims)
        dynamic = None
        launch = re.search(rf"\b{name}\s*(?:<[^<>]*>)?\s*<<<([^>]*)>>>",
                           code)
        if launch:
            args = [a.strip() for a in launch.group(1).split(",")]
            dynamic = _eval(args[2], consts) if len(args) > 2 else 0
        kernels[name] = Kernel(name, line(m.start()), threads, min_blocks,
                               shared, dynamic)
    entries: Dict[str, int] = {}
    for block in re.finditer(r'extern\s+"C"\s*{', code):
        body = _body(code, block.start())
        base = block.start() + code[block.start():].index("{")
        for m in re.finditer(r"^\s*int\s+(\w+)\s*\(", body, re.M):
            entries[m.group(1)] = line(base + m.start(1))
    return Source(Path(path), consts, kernels, entries)


def _rel(path: Path) -> str:
    parts = Path(path).resolve().parts
    if "src" in parts:
        return "/".join(parts[parts.index("src"):])
    return str(path)


# ---------------------------------------------------------------- K1 source

def lint_registry(csrc: Path = CSRC, probes: Sequence[Probe] = PROBES, *,
                  program: str) -> Tuple[List[Finding], Dict[str, Any]]:
    """K1's source leg over every ``csrc/*.cu`` (see the module doc)."""
    out: List[Finding] = []
    meta: Dict[str, Any] = {"sources": {}}
    sources = {p.stem: scan(p) for p in sorted(Path(csrc).glob("*.cu"))}
    for stem, src in sources.items():
        loc = _rel(src.path)
        mine = [p for p in probes if p.source == stem]
        registered = {p.kernel for p in mine}
        entries = {e for p in mine for e in p.wrapper.ENTRIES.values()}
        meta["sources"][stem] = {"kernels": sorted(src.kernels),
                                 "entries": sorted(src.entries)}
        for name, k in src.kernels.items():
            if name not in registered:
                out.append(finding(
                    "K1", f"__global__ {name} is not registered to a probe "
                          f"(kernel_lint.PROBES): its grid coverage is "
                          f"unchecked", f"{program}:{loc}:{k.line}"))
        launches = [e for e in src.entries
                    if not e.endswith(("_launch_config", "_attributes"))
                    and e != "error_string"]
        for e in launches:
            if e not in entries:
                out.append(finding(
                    "K1", f"extern \"C\" launch entry {e} belongs to no "
                          f"probe's ENTRIES", f"{program}:{loc}:"
                                              f"{src.entries[e]}"))
            for extra in ("_launch_config", "_attributes"):
                if e + extra not in src.entries:
                    out.append(finding(
                        "K1", f"launch entry {e} exports no {e}{extra}: the "
                              f"probes cannot read the launch's "
                              f"{'grid' if extra == '_launch_config' else 'attributes'}",
                        f"{program}:{loc}:{src.entries[e]}"))
        for e in sorted(entries - set(launches)):
            out.append(finding("K1", f"probe entry {e} is not an extern \"C\" "
                                     f"entry of {loc}", f"{program}:{loc}"))
    for p in probes:
        if p.source not in sources or p.kernel not in \
                sources[p.source].kernels:
            out.append(finding("K1", f"probe {p.source}/{p.kernel} names no "
                                     f"kernel of {csrc}", program))
        try:
            p.refuses(torch.zeros((2, 1000)))
        except ValueError:
            continue
        out.append(finding(
            "K1", f"{p.wrapper.__name__} accepts a (2, 1000) input: the "
                  f"kernel walks whole 1024-element tiles, so the wrapper "
                  f"must refuse anything but a (tiles, 1024) view", program))
    return out, meta


# ---------------------------------------------------------------- K3 source

def closed_form(src: Source, kernel: str) -> Dict[str, Any]:
    """The budget a kernel's source declares: static and dynamic shared
    memory, threads per block, the resident blocks it asks for, and the
    register cap those give."""
    k = src.kernels[kernel]
    cap = MAX_REGISTERS_PER_THREAD
    if k.threads and k.min_blocks:
        cap = min(cap, REGISTERS_PER_SM // (k.threads * k.min_blocks))
    return {"static_shared_bytes": k.static_shared,
            "dynamic_shared_bytes": k.dynamic_shared,
            "threads": k.threads, "min_blocks": k.min_blocks,
            "max_registers": cap}


def lint_budget(csrc: Path = CSRC, *, program: str
                ) -> Tuple[List[Finding], Dict[str, Any]]:
    """K3's closed form for every kernel of ``csrc/*.cu``."""
    out: List[Finding] = []
    meta: Dict[str, Any] = {"static_shared_limit": STATIC_SHARED_LIMIT,
                            "kernels": {}}
    for path in sorted(Path(csrc).glob("*.cu")):
        src = scan(path)
        for name, k in src.kernels.items():
            cf = closed_form(src, name)
            meta["kernels"][name] = cf
            loc = f"{program}:{_rel(path)}:{k.line}"
            if cf["static_shared_bytes"] > STATIC_SHARED_LIMIT:
                out.append(finding(
                    "K3", f"{name}: {cf['static_shared_bytes']} B of static "
                          f"shared memory per block exceeds the "
                          f"{STATIC_SHARED_LIMIT} B a block gets without "
                          f"an opt-in", loc))
            if cf["dynamic_shared_bytes"] is None:
                out.append(finding(
                    "K3", f"{name}: no launch of it found in the source, so "
                          f"its dynamic shared memory is unknown", loc))
            elif cf["dynamic_shared_bytes"] != 0:
                out.append(finding(
                    "K3", f"{name}: the launch passes "
                          f"{cf['dynamic_shared_bytes']} B of dynamic "
                          f"shared memory, which the closed form does not "
                          f"bound", loc))
            if k.threads is None:
                out.append(finding(
                    "K3", f"{name}: no __launch_bounds__, so its registers "
                          f"are not held to its block size", loc))
    return out, meta


# ---------------------------------------------------------------- card legs

def _nan(shape, dtype, dev) -> torch.Tensor:
    return torch.full(shape, float("nan"), dtype=dtype, device=dev)


def _written(name: str, out: torch.Tensor, n: int) -> Optional[str]:
    """Why ``out``'s first n tiles or its guard tile n are wrong, or None."""
    if torch.isnan(out[:n].float()).any():
        tiles = torch.isnan(out[:n].float()).reshape(n, -1).any(dim=1)
        return (f"{name}: {int(tiles.sum())} of {n} tiles keep the NaN "
                f"sentinel (first {int(tiles.nonzero()[0])})")
    if not torch.isnan(out[n].float()).all():
        return f"{name}: the guard tile {n} past the view was written"
    return None


def _sign_topk_case(probe, dtype, n: int, fused: bool, gen, dev):
    mod = probe.wrapper
    tile = mod.BLOCK
    x_half = torch.randn((n + 1, tile), generator=gen, device=dev)
    x_hat = 0.3 * torch.randn((n + 1, tile), generator=gen, device=dev)
    x_half[n], x_hat[n] = float("nan"), float("nan")
    x_half, x_hat = x_half.to(dtype), x_hat.to(dtype)
    q = _nan((n + 1, tile), dtype, dev)
    xn = _nan((n + 1, tile), dtype, dev) if fused else None
    scale = _nan((n + 1,), torch.float32, dev)
    lib, fn = mod.entry(dtype)
    with torch.cuda.device(dev):
        code = fn(x_half.data_ptr(), x_hat.data_ptr() if fused else None,
                  1.0, K_B, n, q.data_ptr(),
                  None if xn is None else xn.data_ptr(), scale.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(lib, code, f"{probe.source} probe")
    torch.cuda.synchronize(dev)
    bad = [w for w in (_written("q", q, n),
                       _written("x_hat_new", xn, n) if fused else None,
                       _written("scale", scale, n)) if w]
    if bad:
        return "; ".join(bad), 0.0, 0
    err = parity.compare_sign_topk(
        x_half[:n], x_hat[:n] if fused else None, 1.0, K_B,
        (q[:n], None if xn is None else xn[:n], scale[:n]))
    return None, err, 0


def _qsgd_case(probe, dtype, n: int, fused: bool, gen, dev):
    mod = probe.wrapper
    tile = mod.BLOCK
    x = torch.randn((n + 1, tile), generator=gen, device=dev)
    u = torch.rand((n + 1, tile), generator=gen, device=dev)
    x[n], u[n] = float("nan"), float("nan")
    x = x.to(dtype)
    out = _nan((n + 1, tile), dtype, dev)
    lib, fn = mod.entry(dtype)
    with torch.cuda.device(dev):
        code = fn(x.data_ptr(), u.data_ptr(), 16, n, out.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(lib, code, f"{probe.source} probe")
    torch.cuda.synchronize(dev)
    bad = _written("out", out, n)
    if bad:
        return bad, 0.0, 0
    err, flips = parity.compare_qsgd(x[:n], u[:n], 16, out[:n])
    return None, err, flips


def _xhat_mix_case(probe, key, n: int, nodes: int, gen, dev):
    """In place, so the view's rows must equal the plain version's (a tile
    left unwritten keeps inputs that differ from it) and the guard tile of
    every row, past the view's row stride, must keep its NaN."""
    mode, dtype = key
    mod = probe.wrapper
    width, ld = n * mod.BLOCK, (n + 1) * mod.BLOCK
    x_hat, x, q, trig, w, roll = parity.make_xhat_mix_case(
        mode, nodes, ld, dtype, dev, seed=int(torch.randint(
            1 << 30, (1,), generator=gen, device=dev)))
    for t in (x_hat, x, q):
        t[:, width:] = float("nan")
    before = tuple(t[:, :width].clone() for t in (x_hat, x, q)) + (trig,)
    coefs, mask = mod._roll_args(roll, nodes) if roll else (None, 0)
    lib, fn = mod.entry(key)
    with torch.cuda.device(dev):
        code = fn(x_hat.data_ptr(), x.data_ptr(), q.data_ptr(),
                  trig.data_ptr(), None if w is None else w.data_ptr(),
                  coefs, mask, parity.XHAT_MIX_GAMMA, nodes, n, ld,
                  torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(lib, code, f"{probe.source} probe")
    torch.cuda.synchronize(dev)
    for name, t in (("x_hat", x_hat), ("x", x)):
        if not torch.isnan(t[:, width:].float()).all():
            return f"{name}: the guard tile past the view was written", \
                0.0, 0
    err = parity.compare_xhat_mix(
        before, (x_hat[:, :width], x[:, :width]), w, roll,
        parity.XHAT_MIX_GAMMA, spec=(key, n, nodes))
    return None, err, 0


# the routing probe's groups, tokens and choices a token: 1 choice, a warp
# less one, one block's chunk past one block, and three groups of two
# blocks and a ragged tail in one launch, the last with the fsdp offsets
MOE_ROUTE_PROBES = ((1, 1, 1), (1, 31, 1), (1, moe_route.CHUNK + 1, 1),
                    (3, (2 * moe_route.CHUNK + 5) // 6 + 1, 6))
_SENTINEL = -7


def _moe_route_case(probe, groups: int, t: int, k: int, seed: int, dev):
    """Both entries through the C interface on one probe shape, at 64
    experts and a capacity near the mean load (the skewed ids drop some):
    every output filled with a sentinel and one guard element past it; the
    counting launch's block counts equal the plain counts of each block's
    chunk, the ranking launch's tables equal the plain version's, every
    element written and every guard left alone."""
    mod = probe.wrapper
    e, n = 64, t * k
    cap = max(8, n // e // 8 * 8)
    spec = ("probe", groups, t, k, e, cap, "low" if groups > 1 else None)
    ids, before = parity.make_moe_route_case(spec, dev, seed)
    ids3 = ids if ids.dim() == 3 else ids[None]
    nb = mod.blocks(n)
    slots = e * cap + 1

    def out(size, dtype):
        return torch.full((size + 1,), _SENTINEL, dtype=dtype, device=dev)
    bc = out(groups * nb * e, torch.int32)
    slot, tfs = out(groups * n, torch.int64), out(groups * slots, torch.int32)
    counts = out(groups * e, torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib, fn = mod.entry("count")
        code = fn(ids3.data_ptr(), ids3.stride(0), ids3.stride(1), groups, t,
                  k, e, nb, bc.data_ptr(), stream)
        kernels.check(lib, code, f"{probe.source} probe")
        lib, fn = mod.entry("rank")
        code = fn(ids3.data_ptr(), ids3.stride(0), ids3.stride(1), groups, t,
                  k, e, cap, nb, kernels.ptr(before),
                  bc.data_ptr() if nb > 1 else None, slot.data_ptr(),
                  tfs.data_ptr(), counts.data_ptr(), stream)
        kernels.check(lib, code, f"{probe.source} probe")
    torch.cuda.synchronize(dev)
    for name, buf in (("block counts", bc), ("slot", slot),
                      ("token_for_slot", tfs), ("counts", counts)):
        if int(buf[-1]) != _SENTINEL:
            return f"{name}: the guard element past the view was written"
        left = int((buf[:-1] == _SENTINEL).sum())
        if left:
            return f"{name}: {left} elements keep the sentinel"
    flat = ids3.reshape(groups, n)
    want_bc = torch.stack([torch.stack([
        torch.bincount(flat[g, b * mod.CHUNK:(b + 1) * mod.CHUNK],
                       minlength=e) for b in range(nb)]) for g in range(groups)])
    if not torch.equal(bc[:-1].view(groups, nb, e).long(), want_bc):
        return "block counts != the plain counts of each block's chunk"
    lead = ids.shape[:-2]
    parity.compare_moe_route(
        ids, before, e, cap, (slot[:-1].view(*lead, t, k),
                              tfs[:-1].view(*lead, slots),
                              counts[:-1].view(*lead, e)),
        spec=(groups, t, k))
    return None


def _moe_route_coverage(probe, device, gen, program
                        ) -> Tuple[List[Finding], Dict[str, Any]]:
    """K1's card leg of the routing kernel: the grid of each probe shape
    from ``_launch_config`` (one block a :data:`moe_route.CHUNK` of a
    group's choices), then :func:`_moe_route_case`."""
    out: List[Finding] = []
    mod = probe.wrapper
    choices = [t * k for _, t, k in MOE_ROUTE_PROBES]
    rec = {"block": 0, "choices": choices,
           "groups": [g for g, _, _ in MOE_ROUTE_PROBES]}
    for key, entry in mod.ENTRIES.items():
        for n in choices:
            with torch.cuda.device(device):
                grid, block = mod.launch_config(key, n)
            rec["block"] = block
            if (grid, block) != (mod.blocks(n), mod.BLOCK):
                out.append(finding(
                    "K1", f"{entry}: grid {grid} x {block} for {n} choices, "
                          f"want {mod.blocks(n)} x {mod.BLOCK}",
                          f"{program}:{entry}"))
    for groups, t, k in MOE_ROUTE_PROBES:
        seed = int(torch.randint(1 << 30, (1,), generator=gen,
                                 device=device))
        try:
            bad = _moe_route_case(probe, groups, t, k, seed, device)
        except AssertionError as e:
            bad = f"kernel != plain version: {e}"
        if bad:
            out.append(finding(
                "K1", f"moe_route on {groups} x {t * k} choices: {bad}",
                f"{program}:moe_route"))
    return out, {entry: dict(rec) for entry in mod.ENTRIES.values()}


# each source's case and its modes, by the label a finding gives them
_CASES = {"sign_topk": (_sign_topk_case, {"": False, " (fused)": True}),
          "qsgd": (_qsgd_case, {"": False}),
          "xhat_mix": (_xhat_mix_case, {f" (n {n})": n for n in
                                        parity.XHAT_MIX_NODES})}


# sources whose card leg walks shapes of their own, not tiles
_COVERAGE = {"moe_route": _moe_route_coverage}


def tile_counts(grid_cap: int, warps: int) -> List[int]:
    """The probe shapes: one tile, one block short of full, one past the
    grid's first stride, and three strides plus a ragged tail."""
    return sorted({n for n in (1, warps - 1, grid_cap * warps + 1,
                               3 * grid_cap * warps + 5) if n > 0})


def lint_coverage_card(device: torch.device, probes: Sequence[Probe] = PROBES,
                       *, program: str
                       ) -> Tuple[List[Finding], Dict[str, Any]]:
    """K1's card leg (see the module doc). A launch that fails raises."""
    out: List[Finding] = []
    meta: Dict[str, Any] = {}
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    for p in probes:
        if p.source in _COVERAGE:
            found, rec = _COVERAGE[p.source](p, device, gen, program)
            out += found
            meta.update(rec)
            continue
        case, modes = _CASES[p.source]
        mod = p.wrapper
        for dtype, entry in mod.ENTRIES.items():
            with torch.cuda.device(device):
                grid_cap, block = mod.launch_config(dtype, 1 << 40)
            warps = block // 32
            counts = tile_counts(grid_cap, warps)
            rec = {"grid_cap": grid_cap, "block": block, "tiles": counts,
                   "max_abs_err": 0.0, "boundary_flips": 0}
            for n in counts:
                with torch.cuda.device(device):
                    grid, _ = mod.launch_config(dtype, n)
                if grid != min(grid_cap, -(-n // warps)):
                    out.append(finding(
                        "K1", f"{entry}: grid {grid} for {n} tiles, want "
                              f"min({grid_cap}, ceil({n} / {warps}))",
                        f"{program}:{entry}"))
                for label, mode in modes.items():
                    try:
                        bad, err, flips = case(p, dtype, n, mode, gen,
                                               device)
                    except AssertionError as e:
                        bad, err, flips = f"kernel != plain version: {e}", \
                            0.0, 0
                    if bad:
                        out.append(finding(
                            "K1", f"{entry} on {n} tiles{label}: {bad}",
                            f"{program}:{entry}"))
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                    rec["boundary_flips"] += flips
            meta[entry] = rec
    torch.cuda.empty_cache()
    return out, meta


def lint_budget_card(csrc: Path = CSRC, probes: Sequence[Probe] = PROBES, *,
                     program: str) -> Tuple[List[Finding], Dict[str, Any]]:
    """K3's card leg: each instantiation's ``_attributes`` against the
    closed form. A failing call raises."""
    out: List[Finding] = []
    meta: Dict[str, Any] = {}
    for p in probes:
        src = scan(Path(csrc) / f"{p.source}.cu")
        cf = closed_form(src, p.kernel)
        mod = p.wrapper
        for dtype, entry in mod.ENTRIES.items():
            a = mod.attributes(dtype)
            _, block = mod.launch_config(dtype, 1)
            meta[entry] = {**a, "closed_form": cf}
            loc = f"{program}:{entry}"
            if a["shared_bytes"] != cf["static_shared_bytes"]:
                out.append(finding(
                    "K3", f"{entry}: {a['shared_bytes']} B of static shared "
                          f"memory on the card, the source's closed form "
                          f"gives {cf['static_shared_bytes']} B", loc))
            if a["num_regs"] > cf["max_registers"]:
                out.append(finding(
                    "K3", f"{entry}: {a['num_regs']} registers per thread "
                          f"past the cap of {cf['max_registers']}", loc))
            if a["max_threads"] < block:
                out.append(finding(
                    "K3", f"{entry}: at most {a['max_threads']} threads per "
                          f"block, the launch uses {block}", loc))
            want = cf["min_blocks"] or 1
            if a["blocks_per_sm"] < want:
                out.append(finding(
                    "K3", f"{entry}: {a['blocks_per_sm']} resident blocks "
                          f"per SM, the source asks for {want}", loc))
            if a["local_bytes"]:
                out.append(finding(
                    "K3", f"{entry}: {a['local_bytes']} B of local memory "
                          f"per thread (a register spill)", loc,
                    severity=WARNING))
    return out, meta


# ----------------------------------------------------------------------- K4

PACKAGE = Path(__file__).resolve().parents[1]
_DENSE_CONTRACTIONS = ("tensordot", "einsum", "matmul")
_DENSE_MAKERS = ("tensor", "as_tensor", "asarray")
_DENSE_SOURCES = ("ws", "w")   # GossipPlan.ws (R, n, n), Topology.w (n, n)
# a contraction counts as mixing work only inside the gossip modules: a
# transformer layer's x @ W is model compute, not an (n, n) consensus term
_GOSSIP_MODULES = ("repro_torch.core.sparq", "repro_torch.core.topology",
                   "repro_torch.dist.sparq_dist")
_DIST_ROOT = "repro_torch.dist.sparq_dist"
_CEILING_N = 10_000            # the n the finding's message quotes


@dataclasses.dataclass
class _Fn:
    module: str
    node: ast.AST
    path: Path
    scope: Dict[str, str]      # names visible in the body -> qualified name


def _module_name(path: Path, root: Path) -> str:
    rel = path.relative_to(root.parent).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def _functions(root: Path) -> Dict[str, _Fn]:
    """Every ``def`` of the package's sources by qualified name
    (``module.outer.inner``), each with the names its body can call: the
    ``def``s of its module and of its enclosing functions, and the names
    its module imports from the package."""
    fns: Dict[str, _Fn] = {}
    for path in sorted(root.rglob("*.py")):
        module = _module_name(path, root)
        tree = ast.parse(path.read_text(), filename=str(path))
        names: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.level == 0:
                for a in node.names:
                    names[a.asname or a.name] = f"{node.module}.{a.name}"
            elif isinstance(node, ast.Import):
                for a in node.names:
                    names[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]

        def visit(body, prefix: str, scope: Dict[str, str]) -> None:
            defs = [n for n in body if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef))]
            scope = {**scope, **{d.name: f"{prefix}.{d.name}" for d in defs}}
            for d in defs:
                q = f"{prefix}.{d.name}"
                inner = [n for n in ast.walk(d) if n is not d and isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef))]
                fns[q] = _Fn(module, d, path, scope)
                # nested defs see the enclosing function's scope
                visit([n for n in d.body if n in inner], q, scope)
        visit(tree.body, module, names)
    return fns


def _callees(fn: _Fn, fns: Dict[str, _Fn]) -> List[str]:
    """The package functions ``fn`` calls by name or as ``module.name``."""
    out = []
    for sub in ast.walk(fn.node):
        if not isinstance(sub, ast.Call):
            continue
        f = sub.func
        if isinstance(f, ast.Name):
            q = fn.scope.get(f.id)
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in fn.scope:
            q = f"{fn.scope[f.value.id]}.{f.attr}"
        else:
            q = None
        if q in fns:
            out.append(q)
    return out


def _dist_reachable(fns: Dict[str, _Fn]) -> List[str]:
    """The functions reachable from the flat engine's module: its builder
    and the step's closures, and what they call."""
    seen = {q for q, fn in fns.items() if fn.module == _DIST_ROOT}
    frontier = list(seen)
    while frontier:
        for callee in _callees(fns[frontier.pop()], fns):
            if callee not in seen:
                seen.add(callee)
                frontier.append(callee)
    return sorted(seen)


def lint_dense_gossip(root: Path = PACKAGE, *, program: str
                      ) -> Tuple[List[Finding], Dict[str, Any]]:
    """K4: tag the dense mixing work reachable from the flat engine
    (``repro_torch.dist.sparq_dist``), each site a WARNING with the O(n^2)
    ceiling: a ``tensordot``, ``einsum``, ``matmul`` or ``@`` inside the
    gossip modules, and a ``tensor``, ``as_tensor`` or ``asarray`` of a
    ``.ws`` or ``.w`` attribute anywhere. The reference reads reachability
    off its call graph (``analysis/callgraph.py``, not applicable as a
    whole); here a small resolver over the package's sources follows the
    calls by name (the ``def``s in scope and the package's imports), which
    is enough for the engine's closures."""
    root = Path(root)
    fns = _functions(root)
    reachable = _dist_reachable(fns)
    out: List[Finding] = []
    sites: set = set()
    gib = 4 * _CEILING_N * _CEILING_N / 2**30
    for q in reachable:
        fn = fns[q]
        gossip = fn.module in _GOSSIP_MODULES
        for sub in ast.walk(fn.node):
            desc = None
            call_attr = (sub.func.attr if isinstance(sub, ast.Call) and
                         isinstance(sub.func, ast.Attribute) else None)
            if gossip and call_attr in _DENSE_CONTRACTIONS:
                desc = f"dense {call_attr} contraction"
            elif gossip and isinstance(sub, ast.BinOp) and \
                    isinstance(sub.op, ast.MatMult):
                desc = "dense @ contraction"
            elif call_attr in _DENSE_MAKERS and sub.args and \
                    isinstance(sub.args[0], ast.Attribute) and \
                    sub.args[0].attr in _DENSE_SOURCES:
                desc = (f"dense mixing-matrix materialization "
                        f"(.{sub.args[0].attr})")
            if desc is None:
                continue
            key = (fn.path, sub.lineno)
            if key in sites:
                continue
            sites.add(key)
            rel = fn.path.relative_to(root.parent).as_posix()
            out.append(finding(
                "K4", f"{desc} in {fn.node.name}() is reachable from the "
                      f"flat engine's step: O(n^2) in the ensemble size; at "
                      f"n={_CEILING_N} one (n, n) float32 mixing matrix is "
                      f"{gib:.1f} GiB per round (sparse gossip would lift "
                      f"the ceiling)", f"{program}:{rel}:{sub.lineno}"))
    return out, {"dist_reachable": len(reachable), "dense_sites": len(sites)}
