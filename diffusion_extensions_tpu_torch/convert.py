"""Weights of the JAX package's flax models -> the port's modules.

``planenet_params_from_flax(params_np)``,
``rot_predict_params_from_flax(params_np)`` and
``protnet_params_from_flax(params_np)`` take a flax parameter tree as
nested dicts of numpy arrays (with or without the top-level ``"params"``
key) and return a state dict for ``models.planenet.PlaneNet``,
``models.rot_predict.RotPredict`` or ``models.protnet.ProtNet``; the
``*_config_from_flax`` functions give the constructor arguments.
``adam_state_from_optax(mu_np, nu_np, count)`` maps the two moment trees of
an optax Adam state (``ScaleByAdamState`` or the JAX package's
``FusedAdamState``) through the same name mappings into a state that
``train.optim.Adam.load_state_dict`` takes, so both packages can start from
one mid-training state.  flax ``Dense`` kernels are (in, out) and are
transposed for ``nn.Linear``; the attention q/k/v kernels are (dim, heads,
head_dim) with (heads, head_dim) biases, the output kernel (heads, head_dim,
dim); conv kernels (3, Cin, Cout) become (Cout, Cin, 3).  Any missing, extra
or mis-shaped leaf raises.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "planenet_params_from_flax",
    "planenet_config_from_flax",
    "rot_predict_params_from_flax",
    "rot_predict_config_from_flax",
    "protnet_params_from_flax",
    "protnet_config_from_flax",
    "adam_state_from_optax",
]

_ENC = "TransformerEncoder_0"
_MHA = "MultiHeadDotProductAttention_0"


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _unwrap(params_np):
    return params_np["params"] if "params" in params_np else params_np


def planenet_config_from_flax(params_np) -> dict:
    """(dim, heads, layers) of a flax PlaneNet parameter tree."""
    p = _unwrap(params_np)
    try:
        enc = p[_ENC]
        layers = len([k for k in enc if k.startswith("TransformerEncoderLayer_")])
        dim, heads, _ = np.shape(enc["TransformerEncoderLayer_0"][_MHA]["query"]["kernel"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"not a flax PlaneNet parameter tree: {e!r}") from None
    return {"dim": int(dim), "heads": int(heads), "layers": layers}


def _dense(src, dst):
    """flax Dense (in, out) kernel -> nn.Linear (out, in) weight."""
    return {
        f"{src}/kernel": (f"{dst}.weight", lambda a: a.T),
        f"{src}/bias": (f"{dst}.bias", lambda a: a),
    }


def _block_mapping(src: str, dst: str) -> dict:
    """One post-norm attention block (``TransformerEncoderLayer`` or
    ``TransformerCrossLayer``): flax paths under ``src`` -> port keys under
    ``dst``."""
    m = {}
    for name in ("query", "key", "value"):
        m[f"{src}/{_MHA}/{name}/kernel"] = (
            f"{dst}.{name}.weight", lambda a: a.reshape(a.shape[0], -1).T
        )
        m[f"{src}/{_MHA}/{name}/bias"] = (f"{dst}.{name}.bias", lambda a: a.reshape(-1))
    m[f"{src}/{_MHA}/out/kernel"] = (f"{dst}.out.weight", lambda a: a.reshape(-1, a.shape[-1]).T)
    m[f"{src}/{_MHA}/out/bias"] = (f"{dst}.out.bias", lambda a: a)
    for j, norm in ((0, "norm1"), (1, "norm2")):
        m.update(_layer_norm(f"{src}/LayerNorm_{j}", f"{dst}.{norm}"))
    m.update(_dense(f"{src}/Dense_0", f"{dst}.ff1"))
    m.update(_dense(f"{src}/Dense_1", f"{dst}.ff2"))
    return m


def _layer_norm(src, dst):
    return {f"{src}/scale": (f"{dst}.weight", lambda a: a),
            f"{src}/bias": (f"{dst}.bias", lambda a: a)}


def _block_shapes(src: str, dim: int, heads: int, dff: int = 2048) -> dict:
    hd = dim // heads
    s = {}
    for name in ("query", "key", "value"):
        s[f"{src}/{_MHA}/{name}/kernel"] = (dim, heads, hd)
        s[f"{src}/{_MHA}/{name}/bias"] = (heads, hd)
    s[f"{src}/{_MHA}/out/kernel"] = (heads, hd, dim)
    s[f"{src}/{_MHA}/out/bias"] = (dim,)
    for j in (0, 1):
        s[f"{src}/LayerNorm_{j}/scale"] = (dim,)
        s[f"{src}/LayerNorm_{j}/bias"] = (dim,)
    s.update(_dense_shapes(f"{src}/Dense_0", dim, dff))
    s.update(_dense_shapes(f"{src}/Dense_1", dff, dim))
    return s


def _dense_shapes(src: str, fan_in: int, fan_out: int) -> dict:
    return {f"{src}/kernel": (fan_in, fan_out), f"{src}/bias": (fan_out,)}


def _mapping(layers: int) -> dict:
    """flax leaf path -> (state-dict key, numpy transform)."""
    m = {}
    m.update(_dense("Siren_0/Dense_0", "siren.lin"))
    m.update(_dense("Siren_0/Dense_1", "siren.post"))
    for i in range(layers):
        m.update(_block_mapping(f"{_ENC}/TransformerEncoderLayer_{i}", f"encoder.layers.{i}"))
    m.update(_dense("PoolRN_0/Dense_0", "pool.gate"))
    m.update(_dense("PoolRN_0/Dense_1", "pool.val"))
    m.update(_dense("Dense_0", "head"))
    return m


def _expected_shapes(dim: int, heads: int, layers: int, dff: int = 2048) -> dict:
    half = dim // 2
    s = {
        "Siren_0/Dense_0/kernel": (3, half), "Siren_0/Dense_0/bias": (half,),
        "Siren_0/Dense_1/kernel": (half, half), "Siren_0/Dense_1/bias": (half,),
        "PoolRN_0/Dense_0/kernel": (dim, 1), "PoolRN_0/Dense_0/bias": (1,),
        "PoolRN_0/Dense_1/kernel": (dim, dim), "PoolRN_0/Dense_1/bias": (dim,),
        "Dense_0/kernel": (dim, 3), "Dense_0/bias": (3,),
    }
    for i in range(layers):
        s.update(_block_shapes(f"{_ENC}/TransformerEncoderLayer_{i}", dim, heads, dff))
    return s


def _convert(name: str, params_np, expected: dict, mapping: dict) -> dict[str, torch.Tensor]:
    """Check the tree's leaves against ``expected`` shapes, then map them."""
    leaves = _flatten(_unwrap(params_np))
    missing = sorted(set(expected) - set(leaves))
    extra = sorted(set(leaves) - set(expected))
    if missing or extra:
        raise ValueError(f"flax {name} tree: missing {missing}, extra {extra}")
    bad = {k: (leaves[k].shape, v) for k, v in expected.items() if leaves[k].shape != v}
    if bad:
        raise ValueError(f"flax {name} tree: mis-shaped leaves (got, want): {bad}")
    out = {}
    for path, (key, fn) in mapping.items():
        out[key] = torch.tensor(np.ascontiguousarray(fn(leaves[path]), dtype=np.float32))
    return out


def planenet_params_from_flax(params_np) -> dict[str, torch.Tensor]:
    """State dict for ``PlaneNet(**planenet_config_from_flax(params_np))``."""
    cfg = planenet_config_from_flax(params_np)
    expected = _expected_shapes(cfg["dim"], cfg["heads"], cfg["layers"])
    return _convert("PlaneNet", params_np, expected, _mapping(cfg["layers"]))


def rot_predict_config_from_flax(params_np) -> dict:
    """(d_model, out_type, variant) of a flax RotPredict parameter tree: the
    "resnet" variant has ``ResMLPBlock_i`` leaves and one top-level Dense,
    the "mlp" variant five top-level Dense layers."""
    p = _unwrap(params_np)
    try:
        resnet = "ResMLPBlock_0" in p
        d_model = int(np.shape(p["Dense_0"]["kernel"])[0])
        head = "Dense_0" if resnet else "Dense_4"
        d_out = int(np.shape(p[head]["kernel"])[1])
    except (KeyError, TypeError, IndexError) as e:
        raise ValueError(f"not a flax RotPredict parameter tree: {e!r}") from None
    if d_out not in (3, 6):
        raise ValueError(f"flax RotPredict tree: head width {d_out}, expected 3 or 6")
    return {"d_model": d_model, "out_type": "skewvec" if d_out == 3 else "rotmat",
            "variant": "resnet" if resnet else "mlp"}


def rot_predict_params_from_flax(params_np) -> dict[str, torch.Tensor]:
    """State dict for ``RotPredict(**rot_predict_config_from_flax(params_np))``."""
    cfg = rot_predict_config_from_flax(params_np)
    d, d_out = cfg["d_model"], 3 if cfg["out_type"] == "skewvec" else 6
    if cfg["variant"] == "resnet":
        hidden = [(f"ResMLPBlock_{i}/Dense_0", f"hidden.{i}.lin") for i in range(6)]
        head = "Dense_0"
    else:
        hidden = [(f"Dense_{i}", f"hidden.{i}") for i in range(4)]
        head = "Dense_4"
    expected, mapping = {}, {}
    for src, dst in hidden:
        expected.update({f"{src}/kernel": (d, d), f"{src}/bias": (d,)})
        mapping.update(_dense(src, dst))
    expected.update({f"{head}/kernel": (d, d_out), f"{head}/bias": (d_out,)})
    mapping.update(_dense(head, "out"))
    return _convert("RotPredict", params_np, expected, mapping)


def protnet_config_from_flax(params_np) -> dict:
    """ProtNet constructor arguments of a flax ProtNet parameter tree:
    dim, heads, t_depth, c_depth, share_encoders, cross_depth, and the
    readout flags, read from the head's input width (3 dim + 6, + 78 with
    ``equiv_head``, + 72 with ``frame_pool``, + 36 with ``rel_frame``)."""
    p = _unwrap(params_np)
    try:
        enc = p[_ENC]
        t_depth = len([k for k in enc if k.startswith("TransformerEncoderLayer_")])
        dim, heads, _ = np.shape(enc["TransformerEncoderLayer_0"][_MHA]["query"]["kernel"])
        c_depth = len([k for k in p["_ResConv_0"] if k.startswith("Conv_")])
        n_dense = len([k for k in p if k.startswith("Dense_")])
        equiv_head = n_dense == 6
        head_in = int(np.shape(p[f"Dense_{n_dense - 5}"]["kernel"])[0])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"not a flax ProtNet parameter tree: {e!r}") from None
    extra = head_in - 3 * int(dim) - 6 - (78 if equiv_head else 0)
    flags = {0: (False, False), 72: (True, False), 36: (False, True), 108: (True, True)}
    if n_dense not in (5, 6) or extra not in flags:
        raise ValueError(f"flax ProtNet tree: {n_dense} top-level Dense layers, head input "
                         f"{head_in} at dim {dim}: no flag set matches")
    frame_pool, rel_frame = flags[extra]
    return {"dim": int(dim), "heads": int(heads), "t_depth": t_depth, "c_depth": c_depth,
            "share_encoders": "TransformerEncoder_1" not in p,
            "cross_depth": len([k for k in p if k.startswith("TransformerCrossLayer_")]) // 2,
            "frame_pool": frame_pool, "rel_frame": rel_frame, "equiv_head": equiv_head}


def _protnet_tables(cfg: dict, dff: int = 2048) -> tuple[dict, dict]:
    """(expected shapes, mapping) of a flax ProtNet tree.  flax names
    modules by creation order: Siren_0 positions, Siren_1 frames;
    TransformerEncoder_1 only without shared encoders; the cross layers
    alternate receptor and ligand; PoolRN/PoolPos/PoolFrame _0 receptor,
    _1 ligand; with ``equiv_head`` the moment gate ``Dense_0`` comes before
    the head's four hidden Dense layers and its output Dense."""
    dim, heads = cfg["dim"], cfg["heads"]
    pos_dim, ang_dim = dim // 2, dim // 4
    res_dim = dim - pos_dim - ang_dim
    shapes, m = {}, {}

    def dense(src, dst, fan_in, fan_out):
        shapes.update(_dense_shapes(src, fan_in, fan_out))
        m.update(_dense(src, dst))

    for i, (name, fan_in, width) in enumerate((("pos_emb", 3, pos_dim), ("ang_emb", 9, ang_dim))):
        dense(f"Siren_{i}/Dense_0", f"{name}.lin", fan_in, width)
        dense(f"Siren_{i}/Dense_1", f"{name}.post", width, width)
    widths = [21] + [dim] * (cfg["c_depth"] - 1) + [res_dim]
    for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
        src, dst = f"_ResConv_0/Conv_{i}", f"res_conv.convs.{i}"
        shapes[f"{src}/kernel"], shapes[f"{src}/bias"] = (3, cin, cout), (cout,)
        m[f"{src}/kernel"] = (f"{dst}.weight", lambda a: a.transpose(2, 1, 0))
        m[f"{src}/bias"] = (f"{dst}.bias", lambda a: a)
    encoders = ["rec_tf"] if cfg["share_encoders"] else ["rec_tf", "lig_tf"]
    for e, dst in enumerate(encoders):
        for i in range(cfg["t_depth"]):
            src = f"TransformerEncoder_{e}/TransformerEncoderLayer_{i}"
            shapes.update(_block_shapes(src, dim, heads, dff))
            m.update(_block_mapping(src, f"{dst}.layers.{i}"))
        src = f"TransformerEncoder_{e}/LayerNorm_0"
        shapes.update({f"{src}/scale": (dim,), f"{src}/bias": (dim,)})
        m.update(_layer_norm(src, f"{dst}.norm"))
    for j in range(2 * cfg["cross_depth"]):
        shapes.update(_block_shapes(f"TransformerCrossLayer_{j}", dim, heads, dff))
        m.update(_block_mapping(f"TransformerCrossLayer_{j}", f"cross.{j}"))
    for i, side in enumerate(("r", "l")):
        dense(f"PoolRN_{i}/Dense_0", f"{side}_pool.gate", dim, 1)
        dense(f"PoolRN_{i}/Dense_1", f"{side}_pool.val", dim, dim)
        dense(f"PoolPos_{i}/Dense_0", f"{side}_pos.gate", dim, 1)
        if cfg["frame_pool"] or cfg["rel_frame"] or cfg["equiv_head"]:
            dense(f"PoolFrame_{i}/Dense_0", f"{side}_frame.gate", dim, 4)
    first = 0
    if cfg["equiv_head"]:
        dense("Dense_0", "moment_gate", dim, 2)
        first = 1
    head_in = (3 * dim + 6 + (78 if cfg["equiv_head"] else 0) + (72 if cfg["frame_pool"] else 0)
               + (36 if cfg["rel_frame"] else 0))
    dense(f"Dense_{first}", "head_in", head_in, dim)
    for i in range(3):
        dense(f"Dense_{first + 1 + i}", f"head_hidden.{i}", dim, dim)
    dense(f"Dense_{first + 4}", "head_out", dim, 6)
    return shapes, m


def protnet_params_from_flax(params_np) -> dict[str, torch.Tensor]:
    """State dict for ``ProtNet(**protnet_config_from_flax(params_np))``."""
    shapes, mapping = _protnet_tables(protnet_config_from_flax(params_np))
    return _convert("ProtNet", params_np, shapes, mapping)


def adam_state_from_optax(mu_np, nu_np, count, state_dtype=torch.float32) -> dict:
    """Optimizer state for ``train.optim.Adam.load_state_dict`` from the
    ``mu`` and ``nu`` trees (nested dicts of numpy arrays, shaped as the
    flax PlaneNet or RotPredict parameter tree they belong to) and the
    ``count`` of an optax Adam state.  ``state_dtype``: the port
    optimizer's moment dtype (``torch.bfloat16`` for moments that optax
    stored in bf16; the cast from float32 is then exact)."""
    try:
        planenet_config_from_flax(mu_np)
        to_state = planenet_params_from_flax
    except ValueError:
        to_state = rot_predict_params_from_flax
    return {
        "count": torch.tensor(int(count), dtype=torch.int32),
        "mu": {k: v.to(state_dtype) for k, v in to_state(mu_np).items()},
        "nu": {k: v.to(state_dtype) for k, v in to_state(nu_np).items()},
    }
