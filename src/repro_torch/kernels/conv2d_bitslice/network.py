"""Graph-structured CNN inference that stays in the HOBFLOPS bitslice
domain.

The paper's throughput story (§3.4, Fig. 5) assumes IFM data remains in
bitslice format *between* layers, and its headline pitch is arbitrary
per-layer custom precision.  :class:`NetworkGraph` realizes both for
real topologies — residual blocks, pooled classifier heads, strided
downsamples — not just straight conv chains:

* Nodes are **named** and carry explicit input edges; kinds are
  ``conv``, ``maxpool2d``, ``avgpool2d``, ``add``, ``cast``, ``relu``
  (plus the implicit ``input``).  References are checked at insertion
  (nodes are declared before use, so the graph is a DAG by
  construction) and channel compatibility is validated when the graph
  is frozen by :meth:`NetworkGraph.output`.
* Every node has an *operand format*: convs take a per-node
  ``precision`` (``fmt``), ``add``/``cast`` take a target format, pools
  and ``relu`` inherit.  Where a producer's format differs from a
  consumer's operand format the runner inserts a plane-domain
  ``build_cast`` automatically, so one network freely mixes e.g.
  hobflops8 early layers with hobflops11 late layers.
* The topo-order interpreter executes **entirely in the bitslice
  domain**: one ``encode_activations`` at the input node, one
  ``decode_activations`` at the output node, and in between only plane
  ops — the MAC kernel (one launch per conv), ``build_cast``,
  ``build_max`` folds (maxpool), ``build_add`` trees + ``build_scale``
  (avgpool, residual adds), and the one-ANDN-per-plane ReLU.

``run_roundtrip`` executes the same graph with **f32 edges**: every
node encodes its inputs, applies the word-parallel softfloat oracle
(``fp_max``/``fp_add``/``fp_scale``/``fp_relu`` on numpy code words,
``fp_cast`` via encode), and decodes; convs run one layer each through
``hobflops_conv2d``.  Because ``encode`` is exact on decoded values and
each plane netlist is verified bit-exactly against its oracle, the two
paths are bit-identical.

:class:`HobflopsNetwork` is a thin wrapper that lowers a
``Sequence[ConvLayerSpec]`` onto a linear graph.

Entry points run on ``device`` (default ``"cuda"``; constructing one on
a machine without a card raises) and return float32 tensors there.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Sequence

import numpy as np
import torch

from repro_torch._build import resolve_device
from repro_torch.core import softfloat as sf
from repro_torch.core.fpformat import RNE, FPFormat
from repro_torch.core.fused_backend import fused_variant
from repro_torch.kernels.conv2d_bitslice.ops import (ConvWeights, _conv_pad,
                                                     _fold_pairwise,
                                                     add_activations,
                                                     avgpool2d_activations,
                                                     cast_activations,
                                                     conv_core, conv_out_hw,
                                                     decode_activations,
                                                     encode_activations,
                                                     encode_conv_weights,
                                                     hobflops_conv2d,
                                                     maxpool2d_activations,
                                                     neg_inf_code,
                                                     relu_activations)

@dataclasses.dataclass(frozen=True)
class GraphNode:
    """One node of a :class:`NetworkGraph` (hashable and frozen: the
    node tuple is the graph's structure).  ``precision`` is the operand
    format for ``conv``, the target format for ``cast``/``add`` (None on ``add``
    means "first input's format"), and unused elsewhere.  ``blocks``
    holds conv launch-parameter overrides (p_block/m_block/c_block/
    c_unroll, e.g. a ``tune_conv_blocks`` winner) as a sorted item
    tuple; empty means the shape-derived defaults."""
    name: str
    kind: str
    inputs: tuple[str, ...] = ()
    precision: FPFormat | None = None
    stride: int = 1
    padding: str = "SAME"
    relu: bool = False
    extended: bool = False
    rounding: str = RNE
    window: tuple[int, int] = (2, 2)
    blocks: tuple = ()


class GraphValidationError(ValueError):
    """A topology/shape/format inconsistency, named after its node."""


def _format_plan(nodes: tuple[GraphNode, ...],
                 input_fmt: FPFormat) -> dict[str, FPFormat]:
    """Output format of every node.  Convs emit the accumulator format
    ``precision.mult_out(extended)``; casts/adds emit their target;
    pools and relu inherit their input's format."""
    fmts: dict[str, FPFormat] = {}
    for nd in nodes:
        if nd.kind == "input":
            fmts[nd.name] = input_fmt
        elif nd.kind == "conv":
            fmts[nd.name] = nd.precision.mult_out(nd.extended)
        elif nd.kind == "cast":
            fmts[nd.name] = nd.precision
        elif nd.kind == "add":
            fmts[nd.name] = nd.precision or fmts[nd.inputs[0]]
        else:  # maxpool2d / avgpool2d / relu
            fmts[nd.name] = fmts[nd.inputs[0]]
    return fmts


# ---------------------------------------------------------------------------
# Topo-order interpreters
# ---------------------------------------------------------------------------
def _exec_resident(images, weights, *, nodes, out_name, input_fmt,
                   backend):
    """Bitslice-resident execution: one encode, one decode, every edge
    a :class:`BitsliceActivation` in the plane domain."""
    fmts = _format_plan(nodes, input_fmt)
    acts = {}
    for nd in nodes:
        if nd.kind == "input":
            acts[nd.name] = encode_activations(images, input_fmt,
                                               nd.rounding)
            continue
        x = acts[nd.inputs[0]]
        if nd.kind == "conv":
            x = cast_activations(x, nd.precision, nd.rounding)
            out = conv_core(x, weights[nd.name], stride=nd.stride,
                            padding=nd.padding, extended=nd.extended,
                            rounding=nd.rounding, relu=nd.relu,
                            backend=backend, **dict(nd.blocks))
        elif nd.kind == "cast":
            out = cast_activations(x, nd.precision, nd.rounding)
        elif nd.kind == "relu":
            out = relu_activations(x)
        elif nd.kind == "maxpool2d":
            out = maxpool2d_activations(x, nd.window, stride=nd.stride,
                                        padding=nd.padding)
        elif nd.kind == "avgpool2d":
            out = avgpool2d_activations(x, nd.window, stride=nd.stride,
                                        padding=nd.padding,
                                        rounding=nd.rounding)
        elif nd.kind == "add":
            out = add_activations(x, acts[nd.inputs[1]], fmts[nd.name],
                                  nd.rounding)
        else:  # pragma: no cover
            raise ValueError(nd.kind)
        acts[nd.name] = out
    return decode_activations(acts[out_name])


def _codes_np(x: torch.Tensor, fmt: FPFormat, rounding: str = RNE):
    """f32 tensor -> int64 numpy code words (the oracles' domain)."""
    return sf.encode_torch(x, fmt, rounding).cpu().numpy().astype(np.int64)


def _decode_np(codes: np.ndarray, fmt: FPFormat, like: torch.Tensor):
    """int64 numpy code words -> f32 tensor on the device of ``like``."""
    return sf.decode_torch(torch.from_numpy(codes.astype(np.int32))
                           .to(like.device), fmt)


def _window_codes(codes, kh, kw, stride, pad_h, pad_w, fill):
    """NHWC code-word windows for the word-parallel pooling oracle —
    same geometry (low-half-first pad split, strided gather) as the
    plane-domain ``window_gather_planes``."""
    ph0, pw0 = pad_h // 2, pad_w // 2
    x = np.pad(codes, ((0, 0), (ph0, pad_h - ph0), (pw0, pad_w - pw0),
                       (0, 0)), constant_values=fill)
    Ho = (x.shape[1] - kh) // stride + 1
    Wo = (x.shape[2] - kw) // stride + 1
    return [x[:, i:i + (Ho - 1) * stride + 1:stride,
              j:j + (Wo - 1) * stride + 1:stride, :]
            for i in range(kh) for j in range(kw)]


def _oracle_pool(x, fmt, nd: GraphNode):
    """f32 -> f32 pooling through the word-parallel code oracle
    (``fp_max`` or ``fp_add``-tree + ``fp_scale``), bit-exact to the
    plane-domain netlist fold."""
    kh, kw = nd.window
    B, H, W, C = x.shape
    pad_h, pad_w = _conv_pad(H, W, kh, kw, nd.stride, nd.padding)
    codes = _codes_np(x, fmt)
    if nd.kind == "maxpool2d":
        wins = _window_codes(codes, kh, kw, nd.stride, pad_h, pad_w,
                             neg_inf_code(fmt))
        out = _fold_pairwise(wins, lambda a, b: sf.fp_max(a, b, fmt))
    else:
        wins = _window_codes(codes, kh, kw, nd.stride, pad_h, pad_w, 0)
        out = _fold_pairwise(
            wins, lambda a, b: sf.fp_add(a, b, fmt, nd.rounding))
        out = sf.fp_scale(out, (kh * kw).bit_length() - 1, fmt)
    return _decode_np(out, fmt, x)


def _exec_roundtrip(images, weights, *, nodes, out_name, input_fmt,
                    backend):
    """Per-layer f32-boundary oracle: every edge is float32; each node
    encodes, applies the word-parallel softfloat oracle, and decodes.
    Bit-exact to :func:`_exec_resident` (encode is exact on decoded
    values, and every plane netlist is oracle-verified)."""
    fmts = _format_plan(nodes, input_fmt)
    vals = {}
    for nd in nodes:
        if nd.kind == "input":
            # Quantize through the entry format exactly like the
            # resident path's single entry encode; every downstream
            # re-encode then operates on exactly-representable values,
            # which is what makes the two paths bit-identical.
            codes = sf.encode_torch(images, input_fmt, nd.rounding)
            vals[nd.name] = sf.decode_torch(codes, input_fmt)
            continue
        x = vals[nd.inputs[0]]
        fmt_in = fmts[nd.inputs[0]]
        if nd.kind == "conv":
            out = hobflops_conv2d(x, weights[nd.name], fmt=nd.precision,
                                  stride=nd.stride, padding=nd.padding,
                                  relu=nd.relu, extended=nd.extended,
                                  rounding=nd.rounding, backend=backend,
                                  device=x.device, **dict(nd.blocks))
        elif nd.kind == "cast":
            codes = sf.encode_torch(x, nd.precision, nd.rounding)
            out = sf.decode_torch(codes, nd.precision)
        elif nd.kind == "relu":
            out = _decode_np(sf.fp_relu(_codes_np(x, fmt_in), fmt_in),
                             fmt_in, x)
        elif nd.kind in ("maxpool2d", "avgpool2d"):
            out = _oracle_pool(x, fmt_in, nd)
        elif nd.kind == "add":
            tgt = fmts[nd.name]
            ca = _codes_np(x, tgt, nd.rounding)
            cb = _codes_np(vals[nd.inputs[1]], tgt, nd.rounding)
            out = _decode_np(sf.fp_add(ca, cb, tgt, nd.rounding), tgt, x)
        else:  # pragma: no cover
            raise ValueError(nd.kind)
        vals[nd.name] = out
    return vals[out_name]


# ---------------------------------------------------------------------------
# The graph builder / validator / runner
# ---------------------------------------------------------------------------
class NetworkGraph:
    """A DAG of HOBFLOPS nodes, executed bitslice-resident.

    >>> g = NetworkGraph(fmt8)                      # on "cuda"
    >>> c1 = g.conv("c1", g.input_name, k1, relu=True)
    >>> p1 = g.maxpool2d("p1", c1, window=2)
    >>> c2 = g.conv("c2", p1, k2, fmt=fmt11)       # mixed precision
    >>> g.output(g.add("res", c2, g.cast("skip", p1, fmt11.mult_out())))
    >>> y = g.run(x)                 # one encode, one decode
    >>> y_ref = g.run_roundtrip(x)   # f32-boundary oracle, bit-exact

    Node-builder methods return the node name so graphs compose as
    chains of calls.  ``output`` freezes the graph, validates channel
    compatibility, and binds both runners.  ``backend`` is
    ``"cuda_fused"`` (default), ``"cuda"`` or ``"torch"`` (CPU only).
    """

    def __init__(self, input_fmt: FPFormat, backend: str = "cuda_fused",
                 device="cuda", input_name: str = "input",
                 input_rounding: str = RNE):
        self.input_fmt = input_fmt
        self.input_name = input_name
        self.backend = backend
        self.device = resolve_device(device)
        self._nodes: dict[str, GraphNode] = {
            input_name: GraphNode(input_name, "input", (), input_fmt,
                                  rounding=input_rounding)}
        self._weights: dict[str, ConvWeights] = {}
        # f32 kernels retained when conv() is given raw arrays, so
        # with_precision() can re-encode the same weights at another
        # format (pre-encoded ConvWeights carry only codes)
        self._kernels_f32: dict[str, np.ndarray] = {}
        self._out: str | None = None
        self._resident_fn = None
        self._roundtrip_fn = None

    # -- builders ----------------------------------------------------------
    def _insert(self, node: GraphNode) -> str:
        if self._out is not None:
            raise GraphValidationError(
                f"graph is frozen (output() was called); cannot add "
                f"node {node.name!r}")
        if node.name in self._nodes:
            raise GraphValidationError(f"duplicate node name {node.name!r}")
        for src in node.inputs:
            if src not in self._nodes:
                raise GraphValidationError(
                    f"node {node.name!r}: unknown input {src!r} "
                    f"(nodes must be declared before use)")
        self._nodes[node.name] = node
        return node.name

    def conv(self, name: str, src: str, kernels, fmt: FPFormat | None = None,
             *, stride: int = 1, padding: str = "SAME", relu: bool = False,
             extended: bool = False, rounding: str = RNE,
             blocks: dict | None = None) -> str:
        """Conv node: ``precision``/``fmt`` is the operand format (the
        graph input format by default); output carries the accumulator
        format ``fmt.mult_out(extended)``.  ``kernels`` is f32
        ``[kh, kw, cin, cout]`` or a pre-encoded :class:`ConvWeights`.
        ``blocks`` optionally pins launch parameters (p_block/m_block/
        c_block/c_unroll) for this node's kernel launch; both runners
        thread them through."""
        fmt = fmt or self.input_fmt
        if blocks:
            bad = set(blocks) - {"p_block", "m_block", "c_block",
                                 "c_unroll"}
            if bad:
                raise GraphValidationError(
                    f"conv {name!r}: unknown launch block keys {bad}")
        if isinstance(kernels, ConvWeights):
            w = kernels.to(self.device)
            if w.fmt != fmt:
                raise GraphValidationError(
                    f"conv {name!r}: pre-encoded weights are {w.fmt}, "
                    f"node precision is {fmt}")
        else:
            kernels = np.asarray(kernels, np.float32)
            w = encode_conv_weights(kernels, fmt, rounding, self.device)
            self._kernels_f32[name] = kernels
        nm = self._insert(GraphNode(name, "conv", (src,), fmt,
                                    stride=stride, padding=padding,
                                    relu=relu, extended=extended,
                                    rounding=rounding,
                                    blocks=tuple(sorted(
                                        (blocks or {}).items()))))
        self._weights[name] = w
        return nm

    def maxpool2d(self, name: str, src: str, window=2, *,
                  stride: int | None = None,
                  padding: str = "VALID") -> str:
        kh, kw = (window, window) if isinstance(window, int) else window
        return self._insert(GraphNode(name, "maxpool2d", (src,),
                                      stride=stride or kh, padding=padding,
                                      window=(kh, kw)))

    def avgpool2d(self, name: str, src: str, window=2, *,
                  stride: int | None = None, padding: str = "VALID",
                  rounding: str = RNE) -> str:
        kh, kw = (window, window) if isinstance(window, int) else window
        if (kh * kw) & (kh * kw - 1):
            raise GraphValidationError(
                f"avgpool2d {name!r}: window area {kh}x{kw} is not a "
                f"power of two (the divider-free add-tree + "
                f"build_scale lowering needs one)")
        return self._insert(GraphNode(name, "avgpool2d", (src,),
                                      stride=stride or kh, padding=padding,
                                      rounding=rounding, window=(kh, kw)))

    def add(self, name: str, a: str, b: str, fmt: FPFormat | None = None,
            *, rounding: str = RNE) -> str:
        """Residual merge.  Branches are auto-cast to ``fmt`` (default:
        the first input's format) before the plane-domain add."""
        return self._insert(GraphNode(name, "add", (a, b), fmt,
                                      rounding=rounding))

    def cast(self, name: str, src: str, fmt: FPFormat, *,
             rounding: str = RNE) -> str:
        return self._insert(GraphNode(name, "cast", (src,), fmt,
                                      rounding=rounding))

    def relu(self, name: str, src: str) -> str:
        return self._insert(GraphNode(name, "relu", (src,)))

    # -- freeze + validate -------------------------------------------------
    def output(self, name: str) -> "NetworkGraph":
        """Mark ``name`` as the graph output, validate the whole graph
        (channel compatibility), prune nodes that do not feed the
        output, and bind the resident + roundtrip runners.  Returns
        self."""
        if name not in self._nodes:
            raise GraphValidationError(f"output(): unknown node {name!r}")
        self._validate_channels()
        self._out = name
        # Prune to the ancestor set of the output: dead branches are
        # never executed.
        live = {name}
        stack = [name]
        while stack:
            for src in self._nodes[stack.pop()].inputs:
                if src not in live:
                    live.add(src)
                    stack.append(src)
        nodes = tuple(nd for nd in self._nodes.values()
                      if nd.name in live)
        self._live_nodes = nodes
        self._live_weights = {k: w for k, w in self._weights.items()
                              if k in live}
        static = dict(nodes=nodes, out_name=name,
                      input_fmt=self.input_fmt, backend=self.backend)
        self._resident_fn = functools.partial(_exec_resident, **static)
        self._roundtrip_fn = functools.partial(_exec_roundtrip, **static)
        return self

    def _validate_channels(self):
        """Channel-count propagation: convs fix the count, every other
        kind preserves it; mismatches raise with both node names."""
        ch: dict[str, int | None] = {}
        for nd in self._nodes.values():
            if nd.kind == "input":
                ch[nd.name] = None
            elif nd.kind == "conv":
                w = self._weights[nd.name]
                src_ch = ch[nd.inputs[0]]
                if src_ch is not None and src_ch != w.cin:
                    raise GraphValidationError(
                        f"conv {nd.name!r}: input {nd.inputs[0]!r} "
                        f"carries {src_ch} channels but the kernels "
                        f"expect cin={w.cin}")
                ch[nd.name] = w.cout
            elif nd.kind == "add":
                ca, cb = ch[nd.inputs[0]], ch[nd.inputs[1]]
                if ca is not None and cb is not None and ca != cb:
                    raise GraphValidationError(
                        f"add {nd.name!r}: inputs {nd.inputs[0]!r} "
                        f"({ca} ch) and {nd.inputs[1]!r} ({cb} ch) "
                        f"disagree")
                ch[nd.name] = ca if ca is not None else cb
            else:
                ch[nd.name] = ch[nd.inputs[0]]

    # -- shape / format plans ---------------------------------------------
    def format_plan(self) -> dict[str, FPFormat]:
        return _format_plan(tuple(self._nodes.values()), self.input_fmt)

    def shape_plan(self, in_shape) -> dict[str, tuple]:
        """NHWC shape of every node's output for a given input shape,
        with named-node errors replacing the old ad-hoc asserts."""
        shapes: dict[str, tuple] = {}
        for nd in self._nodes.values():
            if nd.kind == "input":
                shapes[nd.name] = tuple(in_shape)
                continue
            B, H, W, C = shapes[nd.inputs[0]]
            if nd.kind == "conv":
                w = self._weights[nd.name]
                if C != w.cin:
                    raise GraphValidationError(
                        f"conv {nd.name!r}: input has {C} channels, "
                        f"kernels expect cin={w.cin}")
                Ho, Wo = conv_out_hw(H, W, w.kh, w.kw, nd.stride,
                                     nd.padding)
                if Ho < 1 or Wo < 1:
                    raise GraphValidationError(
                        f"conv {nd.name!r}: kernel {w.kh}x{w.kw} "
                        f"(stride {nd.stride}, {nd.padding}) does not "
                        f"fit the {H}x{W} input")
                shapes[nd.name] = (B, Ho, Wo, w.cout)
            elif nd.kind in ("maxpool2d", "avgpool2d"):
                kh, kw = nd.window
                Ho, Wo = conv_out_hw(H, W, kh, kw, nd.stride, nd.padding)
                if Ho < 1 or Wo < 1:
                    raise GraphValidationError(
                        f"{nd.kind} {nd.name!r}: window {kh}x{kw} "
                        f"(stride {nd.stride}, {nd.padding}) does not "
                        f"fit the {H}x{W} input")
                shapes[nd.name] = (B, Ho, Wo, C)
            elif nd.kind == "add":
                other = shapes[nd.inputs[1]]
                if (B, H, W, C) != other:
                    raise GraphValidationError(
                        f"add {nd.name!r}: branch shapes "
                        f"{(B, H, W, C)} ({nd.inputs[0]!r}) and "
                        f"{other} ({nd.inputs[1]!r}) differ")
                shapes[nd.name] = (B, H, W, C)
            else:  # cast / relu
                shapes[nd.name] = (B, H, W, C)
        return shapes

    def out_shape(self, in_shape) -> tuple[int, int, int, int]:
        assert self._out is not None, "call output() first"
        return self.shape_plan(in_shape)[self._out]

    def with_precision(self, fmt: FPFormat, *,
                       input_fmt: FPFormat | None = None,
                       fmt_map: dict | None = None) -> "NetworkGraph":
        """A same-topology variant of this graph with every conv's
        operand precision replaced by ``fmt`` — the builder for a
        serving engine's precision-degradation ladder (the cheaper
        variant answers the same requests with the same shapes at
        lower cost).

        Format-bearing fields map through a derived table: each
        original conv operand format goes to ``fmt`` and its
        accumulator formats ``mult_out(False/True)`` go to the matching
        ``fmt.mult_out``; explicit ``cast``/``add`` targets and the
        graph input format follow the same table (so a uniform-
        precision graph stays uniform at the new precision, and casts
        that targeted an accumulator format keep targeting the
        accumulator).  ``fmt_map`` overrides/extends the table for
        mixed-precision graphs that need finer control.  Weights are
        re-encoded from the retained f32 kernels; a conv built from
        pre-encoded :class:`ConvWeights` cannot be re-encoded and
        raises.  The variant is frozen iff this graph is frozen (same
        output node).
        """
        mapping: dict[FPFormat, FPFormat] = {}
        for nd in self._nodes.values():
            if nd.kind == "conv":
                old = nd.precision
                mapping[old] = fmt
                for ext in (False, True):
                    mapping[old.mult_out(ext)] = fmt.mult_out(ext)
        mapping.update(fmt_map or {})
        inp = self._nodes[self.input_name]
        g = NetworkGraph(
            input_fmt or mapping.get(self.input_fmt, fmt),
            backend=self.backend, device=self.device,
            input_name=self.input_name, input_rounding=inp.rounding)
        for nd in self._nodes.values():
            if nd.kind == "input":
                continue
            if nd.kind == "conv":
                kernels = self._kernels_f32.get(nd.name)
                if kernels is None:
                    raise GraphValidationError(
                        f"with_precision: conv {nd.name!r} was built "
                        f"from pre-encoded ConvWeights; re-encoding at "
                        f"{fmt} needs the f32 kernels — pass raw "
                        f"arrays to conv() for graphs that degrade")
                g.conv(nd.name, nd.inputs[0], kernels,
                       mapping.get(nd.precision, fmt), stride=nd.stride,
                       padding=nd.padding, relu=nd.relu,
                       extended=nd.extended, rounding=nd.rounding,
                       blocks=dict(nd.blocks) or None)
            elif nd.kind == "maxpool2d":
                g.maxpool2d(nd.name, nd.inputs[0], nd.window,
                            stride=nd.stride, padding=nd.padding)
            elif nd.kind == "avgpool2d":
                g.avgpool2d(nd.name, nd.inputs[0], nd.window,
                            stride=nd.stride, padding=nd.padding,
                            rounding=nd.rounding)
            elif nd.kind == "add":
                g.add(nd.name, nd.inputs[0], nd.inputs[1],
                      mapping.get(nd.precision) if nd.precision
                      else None, rounding=nd.rounding)
            elif nd.kind == "cast":
                g.cast(nd.name, nd.inputs[0],
                       mapping.get(nd.precision, nd.precision),
                       rounding=nd.rounding)
            else:  # relu
                g.relu(nd.name, nd.inputs[0])
        if self._out is not None:
            g.output(self._out)
        return g

    def signature(self) -> str:
        """Stable hash of the graph's *structure*: topology, per-node
        static config, input format, backend, device type, and conv
        weight geometry + format — but NOT weight values.  Graphs with
        equal signatures run interchangeable kernel variants (the digest
        is memoized once the graph is frozen).  On a frozen
        graph only the *live* (output-ancestor) nodes are hashed —
        pruned dead branches are never executed, so
        they must not perturb the signature."""
        if self._out is not None and getattr(self, "_sig", None):
            return self._sig
        parts = [repr((self.input_fmt, self.backend, self.device.type,
                       self._out))]
        nodes = self._live_nodes if self._out is not None \
            else tuple(self._nodes.values())
        for nd in nodes:
            parts.append(repr(dataclasses.astuple(nd)))
            w = self._weights.get(nd.name)
            if w is not None:
                parts.append(repr((w.kh, w.kw, w.cin, w.cout, w.fmt)))
        sig = hashlib.sha256("\n".join(parts).encode()).hexdigest()[:16]
        if self._out is not None:
            self._sig = sig
        return sig

    def summary(self, in_shape) -> str:
        """Per-node table (name, op, output format, output shape, MACs)
        for a concrete input shape — the serve engine's startup log and
        the examples' verbose output.  Nodes appear in insertion order;
        the trailing row totals the conv MACs of one forward pass."""
        shapes = self.shape_plan(in_shape)
        fmts = self.format_plan()

        def fstr(f: FPFormat) -> str:
            return f"e{f.w_e}f{f.w_f}/{f.nbits}b"

        rows = [("node", "op", "format", "out shape", "MACs")]
        total = 0
        for nd in self._nodes.values():
            macs = 0
            if nd.kind == "conv":
                w = self._weights[nd.name]
                B, Ho, Wo, _ = shapes[nd.name]
                macs = B * Ho * Wo * w.kh * w.kw * w.cin * w.cout
            total += macs
            rows.append((nd.name, nd.kind, fstr(fmts[nd.name]),
                         "x".join(str(d) for d in shapes[nd.name]),
                         f"{macs:,}" if macs else "-"))
        rows.append(("total", "", "", "", f"{total:,}"))
        widths = [max(len(r[i]) for r in rows) for i in range(5)]
        lines = []
        for i, r in enumerate(rows):
            lines.append("  ".join(c.ljust(w)
                                   for c, w in zip(r, widths)).rstrip())
            if i == 0:
                lines.append("-" * len(lines[0]))
        return "\n".join(lines)

    def resident_runner(self):
        """The bitslice-resident entrypoint as a bare batched callable
        ``images [B,H,W,C] f32 tensor on the graph's device ->
        [B,Ho,Wo,M] f32`` with the live weights closed over and no
        per-call host-side shape re-validation."""
        assert self._out is not None, "call output() first"
        fn, weights = self._resident_fn, self._live_weights
        return lambda images: fn(images, weights)

    def fused_variants(self) -> set[tuple]:
        """The ``(fmt, k, extended, rounding, relu)`` fused-kernel
        variants the live convs launch on ``cuda_fused`` — what to build
        ahead of a run in one ``nvcc`` call
        (``repro_torch.kernels.build_kernels``)."""
        assert self._out is not None, "call output() first"
        out = set()
        for nd in self._live_nodes:
            if nd.kind == "conv":
                w = self._weights[nd.name]
                out.add(fused_variant(
                    nd.precision, w.kh * w.kw * w.cin, nd.extended,
                    nd.rounding, nd.relu, dict(nd.blocks).get("c_unroll")))
        return out

    def macs(self, in_shape) -> int:
        """Total conv multiply-accumulates for one forward pass."""
        shapes = self.shape_plan(in_shape)
        total = 0
        for nd in self._nodes.values():
            if nd.kind == "conv":
                w = self._weights[nd.name]
                B, Ho, Wo, _ = shapes[nd.name]
                total += B * Ho * Wo * w.kh * w.kw * w.cin * w.cout
        return total

    # -- execution ---------------------------------------------------------
    def _input(self, images) -> torch.Tensor:
        self.shape_plan(tuple(images.shape))      # host-side validation
        return torch.as_tensor(images, dtype=torch.float32,
                               device=self.device)

    def run(self, images) -> torch.Tensor:
        """f32 NHWC -> f32 NHWC, bitslice-resident (single encode,
        single decode; every interior edge in the plane domain)."""
        assert self._out is not None, "call output() first"
        return self._resident_fn(self._input(images), self._live_weights)

    __call__ = run

    def run_roundtrip(self, images) -> torch.Tensor:
        """Same graph with f32 edges and word-parallel oracles at every
        node — the bit-exact per-layer baseline."""
        assert self._out is not None, "call output() first"
        return self._roundtrip_fn(self._input(images), self._live_weights)


# ---------------------------------------------------------------------------
# Sequential API: a thin linear-graph wrapper
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LayerCfg:
    """Static per-layer configuration (hashable)."""
    stride: int = 1
    padding: str = "SAME"
    relu: bool = True
    extended: bool = False
    rounding: str = RNE


@dataclasses.dataclass
class ConvLayerSpec:
    """One conv layer of a :class:`HobflopsNetwork`.

    ``kernels`` is an f32 ``[kh, kw, cin, cout]`` array or a pre-encoded
    :class:`ConvWeights`; ``fmt`` is the layer's *operand* format (the
    accumulator runs at ``fmt.mult_out(extended)`` and is cast back down
    at the next layer's boundary).
    """
    kernels: object
    fmt: FPFormat
    stride: int = 1
    padding: str = "SAME"
    relu: bool = True
    extended: bool = False
    rounding: str = RNE

    def cfg(self) -> LayerCfg:
        return LayerCfg(self.stride, self.padding, self.relu,
                        self.extended, self.rounding)


class HobflopsNetwork:
    """A sequential stack of HOBFLOPS conv layers, bitslice-resident.

    A thin wrapper that lowers the layer list onto a linear
    :class:`NetworkGraph` (nodes ``conv0`` .. ``convN-1``) — one encode,
    one decode per call.

    >>> net = HobflopsNetwork([ConvLayerSpec(k1, fmt), ConvLayerSpec(k2, fmt)])
    >>> y = net(x)                  # one encode, one decode
    >>> y_ref = net.run_roundtrip(x)   # per-layer f32 boundaries (baseline)
    """

    def __init__(self, layers: Sequence[ConvLayerSpec],
                 backend: str = "cuda_fused", device="cuda"):
        assert layers, "need at least one layer"
        g = NetworkGraph(layers[0].fmt, backend=backend, device=device,
                         input_rounding=layers[0].rounding)
        src = g.input_name
        for i, spec in enumerate(layers):
            src = g.conv(f"conv{i}", src, spec.kernels, spec.fmt,
                         stride=spec.stride, padding=spec.padding,
                         relu=spec.relu, extended=spec.extended,
                         rounding=spec.rounding)
        g.output(src)
        self.graph = g
        self._names = tuple(f"conv{i}" for i in range(len(layers)))
        self.weights: tuple[ConvWeights, ...] = tuple(
            g._weights[n] for n in self._names)
        self.cfgs: tuple[LayerCfg, ...] = tuple(s.cfg() for s in layers)
        self.backend = backend

    def __call__(self, images) -> torch.Tensor:
        """f32 NHWC -> f32 NHWC through the bitslice-resident pipeline
        (single activation encode, single decode)."""
        return self.graph.run(images)

    run_resident = __call__

    def run_roundtrip(self, images) -> torch.Tensor:
        """Same network through per-layer f32 boundaries (the oracle
        baseline).  Bit-exact to :meth:`run_resident`."""
        return self.graph.run_roundtrip(images)

    def out_shape(self, in_shape) -> tuple[int, int, int, int]:
        """NHWC output shape for an NHWC input shape."""
        return self.graph.out_shape(in_shape)

    def macs(self, in_shape) -> int:
        """Total multiply-accumulates for one forward pass."""
        return self.graph.macs(in_shape)
