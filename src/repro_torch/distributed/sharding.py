"""Sharding rules: map parameters, AdamW state, batches and caches to
partition specs on the production mesh (DP on (pod, data), TP/EP/SP on
model), and specs to DTensor placements.

The rules are the reference's, as pure functions of (names, shape,
mesh).  A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of axis names (one dimension
split over several mesh axes, major first), as a ``PartitionSpec`` holds
them.  ``mesh`` is anything with ``axis_names``/``shape`` (name -> size),
such as :func:`repro_torch.distributed.mesh_compat.abstract_mesh`, or a
``DeviceMesh`` with ``mesh_dim_names``.

Every rule is divisibility-checked: if a tensor dimension does not divide
the mesh axes it would shard over, the rule falls back (usually to
replication for that dim).  So one rule set serves all ten architectures
-- e.g. qwen2-7b's 28 heads do not divide the 16-way model axis, so its
attention weights are replicated while its 18944-wide FFN shards.

Where the reference stacks ``layers``/``groups``/``tail`` on leading axes,
the port keeps one tensor a layer (``layers.3.attn.wq``): a port
parameter's spec is the reference's spec of the stacked tensor with the
leading axes dropped (:func:`reference_names`, :func:`param_spec`).  The
rules never shard a stacked axis, except ZeRO-1 (:func:`opt_shardings`).
Cache entries keep the reference's stacked layout and names, so their
specs are the reference's whole.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch

from repro_torch.optim.adamw import AdamWState

MODEL = "model"


# ---------------------------------------------------------------------------
# meshes and specs
# ---------------------------------------------------------------------------

def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or an abstract mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_size(mesh, axes) -> int:
    """The ranks along ``axes``: a name, a tuple of names, or None (1)."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in _axes(axes):
        n *= sizes[a]
    return n


def _fit(mesh, dim: int, axes):
    """axes if dim divides their product, else None."""
    return axes if dim % axes_size(mesh, axes) == 0 else None


def shard_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape of one device's shard of a tensor of ``shape``."""
    return tuple(d // axes_size(mesh, e) for d, e in zip(shape, spec))


def shard_bytes(tensor: torch.Tensor, spec, mesh) -> int:
    n = 1
    for d in shard_shape(tensor.shape, spec, mesh):
        n *= d
    return n * tensor.element_size()


def check_spec(name: str, shape, spec, mesh) -> None:
    """Raises ``ValueError`` unless ``spec`` has one entry a dimension of
    ``shape`` and every sharded dimension divides its axes."""
    if len(spec) != len(shape):
        raise ValueError(f"{name}: spec {spec} for shape {tuple(shape)}")
    for dim, entry in zip(shape, spec):
        if dim % axes_size(mesh, entry):
            raise ValueError(f"{name}: dim {dim} of {tuple(shape)} does not "
                             f"divide {entry} in spec {spec}")


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _map_named(fn, tree, names=()):
    """``tree`` with each tensor leaf replaced by ``fn(names, leaf)``;
    ``names`` are the reference's path names (dict keys, ``[i]`` for a
    list position, a named tuple's field names)."""
    if isinstance(tree, Mapping):
        return {k: _map_named(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(fn, v, names + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, names + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(list(names), tree)


def zip_map(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure."""
    if isinstance(tree, Mapping):
        return {k: zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(zip_map(fn, a, b) for a, b in zip(tree, other)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(fn, a, b) for a, b in zip(tree, other))
    return fn(tree, other)


def tree_leaves(tree) -> list:
    out = []
    _map_named(lambda names, leaf: out.append(leaf), tree)
    return out


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _lead(names: list[str]) -> int:
    """Scan-stacked leading axes of a reference parameter: ``layers`` adds
    1, grouped-hybrid ``groups`` adds 2 (group, position-in-group) for
    its Mamba blocks and 1 for its norms, ``tail`` adds 1."""
    if "layers" in names or "tail" in names:
        return 1
    if "groups" in names:
        return 2 if "mamba" in names else 1
    return 0


def _param_spec(names: list[str], shape: tuple[int, ...], mesh) -> tuple:
    """The reference's rule for a (stacked) parameter at path ``names``."""
    name = names[-1]
    lead = _lead(names)
    if name == "norms":                      # grouped norms: replicate all
        return (None,) * len(shape)
    base = shape[lead:]

    def out(*spec):
        full = (None,) * lead + spec
        if len(full) != len(shape):
            raise ValueError(f"{names}: spec {full} for shape {shape}")
        return full

    m = MODEL
    # embeddings / head
    if name == "embed":
        return out(_fit(mesh, base[0], m), None)
    if name == "lm_head":
        return out(None, _fit(mesh, base[1], m))
    # norms / small vectors / gates
    if name in ("ln1", "ln2", "final_norm", "q_norm", "kv_norm",
                "A_log", "D", "dt_bias", "block_norms", "r"):
        return out(*([None] * len(base)))
    # attention (3-D head-major)
    if name in ("wq", "wk", "wv"):
        return out(None, _fit(mesh, base[1], m), None)
    if name in ("bq", "bk", "bv"):
        return out(_fit(mesh, base[0], m), None)
    if name == "wo":
        return out(_fit(mesh, base[0], m), None, None)
    # MLA
    if name in ("w_dq", "w_dkv"):
        return out(None, None)
    if name in ("w_uq", "w_uk", "w_uv"):
        return out(None, _fit(mesh, base[1], m), None)
    # dense MLP (also MoE shared experts / zamba shared mlp)
    if name in ("w_gate", "w_up"):
        if len(base) == 3:  # MoE experts [E, d, f] -> EP on experts
            ep = _fit(mesh, base[0], m)
            return out(ep, None, None if ep else _fit(mesh, base[2], m))
        return out(None, _fit(mesh, base[1], m))
    if name == "w_down":
        if len(base) == 3:
            ep = _fit(mesh, base[0], m)
            return out(ep, None if ep else _fit(mesh, base[1], m), None)
        return out(_fit(mesh, base[0], m), None)
    if name == "router":
        return out(None, None)
    # mamba (head-major)
    if name in ("w_z", "w_x"):
        return out(None, _fit(mesh, base[1], m), None)
    if name in ("w_B", "w_C", "w_dt", "conv_B", "conv_C"):
        return out(*([None] * len(base)))
    if name == "conv_x":
        return out(None, _fit(mesh, base[1], m), None)
    if name == "norm":  # mamba/xlstm norm [H, hd] or [inner]
        if len(base) == 2:
            return out(_fit(mesh, base[0], m), None)
        return out(None)
    if name == "w_out":
        if len(base) == 3:
            return out(_fit(mesh, base[0], m), None, None)
        return out(_fit(mesh, base[0], m), None)
    # xlstm fused projections: replicated (350M model -- pure DP)
    if name in ("w_qkv", "w_if", "w_in"):
        return out(None, None)
    # default: replicate
    return out(*([None] * len(base)))


def _reference_path(port_name: str) -> tuple[list[str], int]:
    """(the reference's path names, the number of stacked leading axes
    the port's tensor lacks): the indices of ``layers``, ``groups`` and
    their ``mamba`` stacks are dropped, a ``blocks``/``block_norms``
    position becomes ``[i]``.  ``tail.norms`` and ``groups.g.norms`` keep
    their own stack of norms, as the reference's do."""
    parts = port_name.split(".")
    head, dropped = parts[0], 0
    if head in ("layers", "groups"):
        parts, dropped = [head] + parts[2:], 1
    if head in ("blocks", "block_norms"):
        parts = [head, f"[{parts[1]}]"] + parts[2:]
    if "mamba" in parts and head in ("groups", "tail"):
        i = parts.index("mamba")
        parts, dropped = parts[:i + 1] + parts[i + 2:], dropped + 1
    return parts, dropped


def reference_names(port_name: str) -> list[str]:
    """The reference's path names of the stacked tensor that holds a port
    parameter: layer and block indices of stacked axes dropped, list
    positions as ``[i]``::

        layers.3.attn.wq      -> [layers, attn, wq]
        groups.1.mamba.2.w_x  -> [groups, mamba, w_x]
        tail.mamba.0.w_x      -> [tail, mamba, w_x]
        blocks.5.w_up         -> [blocks, [5], w_up]
        block_norms.5         -> [block_norms, [5]]
    """
    return _reference_path(port_name)[0]


def param_spec(port_name: str, shape, mesh) -> tuple:
    """A port parameter's spec: the reference's spec of its stacked tensor
    with the stacked (never sharded) leading axes the port lacks
    dropped."""
    names, dropped = _reference_path(port_name)
    full = _param_spec(names, (1,) * dropped + tuple(shape), mesh)
    return full[dropped:]


def _named_params(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


def param_shardings(mesh, params) -> dict:
    """``params``: an LM module, or a dict parameter name -> tensor.
    Returns parameter name -> spec."""
    return {k: param_spec(k, p.shape, mesh)
            for k, p in _named_params(params).items()}


def _zero1(spec: tuple, shape, mesh) -> tuple:
    dp = dp_axes(mesh)
    parts = list(spec)
    for i, dim in enumerate(shape):
        if parts[i] is None and dim % axes_size(mesh, dp) == 0:
            parts[i] = dp
            break
    return tuple(parts)


def opt_shardings(mesh, opt: AdamWState, zero1: bool = False) -> AdamWState:
    """AdamW state: step replicated; the moments follow the parameter
    rules, plus (``zero1``) the DP axes on the first still-replicated
    divisible dim -- ZeRO-1, cutting optimizer memory by the DP degree.

    The reference's ZeRO-1 looks at the stacked tensor, leading axes
    first, so where the layer count divides the DP size it shards the
    stacked axis (musicgen-large's 48 layers on 16x16).  The port has no
    stacked axis: it puts the DP axes on the first dim of the per-layer
    tensor that is still replicated and divides the DP size, or
    nowhere."""
    def moments(tree):
        out = {}
        for k, t in tree.items():
            spec = param_spec(k, t.shape, mesh)
            out[k] = _zero1(spec, t.shape, mesh) if zero1 else spec
        return out

    return AdamWState((), moments(opt.mu), moments(opt.nu))


# ---------------------------------------------------------------------------
# batches / caches
# ---------------------------------------------------------------------------

def batch_shardings(mesh, batch) -> dict:
    """tokens/labels [B,S]; embeds [B,S,d] -- batch over DP axes."""
    dp = dp_axes(mesh)

    def rule(names, leaf):
        if leaf.ndim == 0:
            return ()
        axes = dp if leaf.shape[0] % axes_size(mesh, dp) == 0 else None
        return (axes,) + (None,) * (leaf.ndim - 1)

    return _map_named(rule, batch)


def cache_shardings(mesh, cache, stacked: bool = True,
                    prefer_heads: bool = False):
    """KV/state caches.  Batch -> DP when divisible; the long sequence axis
    -> model (plus the DP axes too when batch is unshardable, e.g. the
    batch-1 long_500k cell: sequence parallelism).

    prefer_heads: shard the KV-head axis instead of sequence when it
    divides the model axis -- position gathers (AES-KV sampling, ring
    reads) then stay shard-local.  Dims are identified from the end, so
    any number of leading stack axes is handled (``stacked`` is kept for
    the reference's signature)."""
    dp = dp_axes(mesh)

    def rule(names, leaf):
        name = names[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec: list = [None] * nd
        if name in ("k", "v"):                 # [..., B, S, KV, hd]
            b_dim, s_dim = nd - 4, nd - 3
            if prefer_heads and shape[-2] % axes_size(mesh, MODEL) == 0:
                spec[nd - 2] = MODEL
                s_dim = None
        elif name in ("k_scale", "v_scale"):   # [..., B, S, KV]
            b_dim, s_dim = nd - 3, nd - 2
            if prefer_heads and shape[-1] % axes_size(mesh, MODEL) == 0:
                spec[nd - 1] = MODEL
                s_dim = None
        elif name in ("c_kv", "k_pe"):         # [..., B, S, r]
            b_dim, s_dim = nd - 3, nd - 2
        elif name == "state":                  # [..., B, H, hd, n]
            b_dim, s_dim = nd - 4, None
            spec[nd - 3] = _fit(mesh, shape[-3], MODEL)
        elif name == "C" and "conv" not in names:  # mlstm [..., B,H,hd,hd+1]
            b_dim, s_dim = nd - 4, None
        elif name == "x" and nd >= 4:          # conv [..., B, K-1, H, hd]
            b_dim, s_dim = nd - 4, None
            spec[nd - 2] = _fit(mesh, shape[-2], MODEL)
        elif name in ("B", "C", "c", "n", "h") or nd >= 2:
            b_dim = max(nd - (3 if name in ("B", "C") else 2), 0)
            s_dim = None
        else:
            b_dim, s_dim = 0, None
        b_ax = dp if shape[b_dim] % axes_size(mesh, dp) == 0 else None
        spec[b_dim] = b_ax
        if s_dim is not None:
            s_axes = MODEL if b_ax else tuple(dp) + (MODEL,)
            spec[s_dim] = _fit(mesh, shape[s_dim], s_axes)
            if spec[s_dim] is None:
                spec[s_dim] = _fit(mesh, shape[s_dim], MODEL)
        return tuple(spec)

    return _map_named(rule, cache)


def logits_sharding(mesh, batch: int) -> tuple:
    dp = dp_axes(mesh)
    b_ax = dp if batch % axes_size(mesh, dp) == 0 else None
    return (b_ax, None, MODEL)


def scalar_sharding(mesh) -> tuple:
    return ()


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def to_placements(spec, mesh) -> list:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)``
    (``d >= 0``) on each mesh dim that shards tensor dim ``d``, in mesh
    order (a tuple ``("pod", "data")`` shards one dim over both, major
    first, as JAX does), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        dims = [names.index(a) for a in _axes(entry)]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {entry} out of mesh order "
                             f"{names}")
        for i in dims:
            placements[i] = Shard(d)
    return placements


def _local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a copy)."""
    coord = mesh.get_coordinate()
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    local = t
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        index, count = 0, 1
        for a in axes:
            index = index * sizes[a] + coord[names.index(a)]
            count *= sizes[a]
        n = t.shape[d] // count
        local = local.narrow(d, index * n, n)
    return local.clone()


def place(tree, specs, mesh):
    """DTensors of ``tree``'s tensors under ``specs`` (a tree of one
    structure) on ``mesh``, built from each rank's local block with
    ``DTensor.from_local`` (no collective, so a fake full-size tensor is
    never scattered)."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        check_spec("tensor", t.shape, spec, mesh)
        return DTensor.from_local(_local_shard(t.detach(), spec, mesh), mesh,
                                  to_placements(spec, mesh), run_check=False,
                                  shape=t.shape, stride=t.stride())

    return zip_map(one, tree, specs)


def check_specs(tree, specs, mesh) -> None:
    """:func:`check_spec` on every leaf of ``tree`` (a one-rank mesh keeps
    its tensors plain, but its rules are still checked)."""
    zip_map(lambda t, spec: check_spec("tensor", t.shape, spec, mesh),
             tree, specs)


#: What the port changed so that a step runs on DTensors: every op
#: rewritten and every rule added for them, by place (the dry run records
#: this tuple as ``registered_strategies``).  No catch-all: an op with no
#: DTensor strategy fails the step.
DTENSOR_REWRITES = (
    "models/moe.py:expert_counts: torch.bincount (no DTensor strategy, "
    "a data-dependent shape) as a comparison and a sum",
    "models/moe.py:_sharded_dispatch: the expert dispatch runs on each "
    "rank's local blocks (local_map): its tokens to the experts it holds, "
    "the sum and the gradients of x and the routing weights pending over "
    "model, the experts' gradients over the DP axes",
    "models/moe.py:_group_sizes: on fake tensors (the dry run), an even "
    "split of the T*K expert rows",
    "models/xlstm.py:mlstm_block: F.logsigmoid (aten.log_sigmoid_backward "
    "has no DTensor strategy) as -softplus(-x)",
    "models/layers.py:softplus: the gradient made contiguous "
    "(aten.softplus_backward's DTensor strides disagree with its local "
    "result, and the matmul backward's view then fails)",
    "models/attention.py:_attend_local, _sharded_mla_core: attention "
    "runs on each rank's batch rows and heads (local_map), a rank taking "
    "its heads' K/V groups; batched products over a split head axis "
    "merge it with the batch, which has no placement",
    "models/attention.py:_attend_over_shards: decode over a "
    "sequence-split cache gathers the heads (one position) and expands "
    "K/V to the heads, so no product merges two split dims",
    "models/ssm.py:_sharded_ssd, models/xlstm.py:_sharded_mlstm, "
    "_sharded_slstm_scan: the Mamba scan on each rank's rows and heads, "
    "the xLSTM blocks on its rows (local_map)",
    "models/lm.py:_sharded_embed, _sharded_nll: the embedding lookup and "
    "the cross entropy with the vocabulary left split (local_map)",
    "models/lm.py:_residual: the residual stream pinned at each layer "
    "boundary to its batch over the DP axes, replicated over model",
    "models/layers.py:contiguous_grads: a local_map block's input "
    "gradients made contiguous (the DTensor wrapping them claims the "
    "forward tensor's strides)",
    "models/attention.py:write_position: a decode write into a "
    "sequence-sharded cache writes the one block holding the position",
)
