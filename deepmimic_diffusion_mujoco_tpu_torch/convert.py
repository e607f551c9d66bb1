"""Flax parameter trees -> PyTorch state dicts.

``temporal_unet_from_flax`` takes the JAX TemporalUnet's params (nested
dicts of numpy arrays, with or without the top-level ``"params"`` key) and
returns a state dict that ``models.temporal_unet.TemporalUnet`` loads with
``strict=True``. The mapping is a table of path patterns:

=======================================================  ==========================================  =========================
flax path                                                torch key                                   transform
=======================================================  ==========================================  =========================
Dense_i/{kernel,bias}                                    time_mlp.i.{weight,bias}                    kernel.T
ResidualTemporalBlock_i/Conv1dBlock_j/conv_kernel        res_blocks.i.blocks.j.weight                none: (k, Cin, Cout)
ResidualTemporalBlock_i/Conv1dBlock_j/conv_bias          res_blocks.i.blocks.j.bias
ResidualTemporalBlock_i/Conv1dBlock_j/gn_scale, gn_bias  res_blocks.i.blocks.j.gn_weight, gn_bias
ResidualTemporalBlock_i/Dense_0/{kernel,bias}            res_blocks.i.time_dense.{weight,bias}       kernel.T
ResidualTemporalBlock_i/Conv_0/{kernel,bias}             res_blocks.i.residual.{weight,bias}         kernel[0].T (1x1 conv)
PreNormResidualAttention_i/{g,b}                         attentions.i.{g,b}                          none: (1, 1, C)
PreNormResidualAttention_i/LinearAttention_0/Conv_0      attentions.i.attn.to_qkv.weight (no bias)   kernel[0].T
PreNormResidualAttention_i/LinearAttention_0/Conv_1      attentions.i.attn.to_out.{weight,bias}      kernel[0].T
Conv_i, i < number of ConvTranspose                      downsamples.i.{weight,bias}                 kernel.transpose(2, 1, 0)
Conv_i, the last one                                     final_conv.{weight,bias}                    kernel[0].T (1x1 conv)
ConvTranspose_i                                          upsamples.i.{weight,bias}                   kernel[::-1].transpose(1, 2, 0)
Conv1dBlock_0/...                                        final_block....                             as Conv1dBlock above
=======================================================  ==========================================  =========================

Flax's ``ConvTranspose(4, stride 2, "SAME")`` equals
``torch.nn.ConvTranspose1d(C, C, 4, stride=2, padding=1)`` only with the
kernel flipped along k (flax does not flip, a true transposed conv does).

``local_transformer_from_flax`` does the same for the JAX LocalTransformer
(``models.local_attention.LocalTransformer``):

=================================================  ====================================  =========
flax path                                          torch key                             transform
=================================================  ====================================  =========
pose_embed, time_embed_{0,1}, final_layer          same name .{weight,bias}              kernel.T
pos_emb                                            pos_emb                               none
class_embed/embedding                              class_embed.weight                    none
dynamic_pos_bias/Dense_i                           dynamic_pos_bias.dense.i              kernel.T
hc_{attn,ff,global}_i/<param>, .../norm/scale      hc_{attn,ff,global}.i.<param>, ...    none
global_attn_i/LayerNorm_0/{scale,bias}             global_attn.i.norm.{weight,bias}      none
global_attn_i/MultiHeadDotProductAttention_0/      global_attn.i.attn.<name>             (D, h, dh) -> (D, h*dh).T;
  {query,key,value,out}/{kernel,bias}                                                    out (h, dh, D) -> (h*dh, D).T
attn_i/LayerNorm_0/{scale,bias}                    attn.i.norm.{weight,bias}             none
attn_i/Dense_0, Dense_1 (no bias)                  attn.i.to_qkv, attn.i.to_out          kernel.T
ff_i/LayerNorm_0, Dense_0, Dense_1                 ff.i.norm, ff.i.proj_in, ff.i.proj_out as above
LayerNorm_0/{scale,bias}                           norm.{weight,bias}                    none
=================================================  ====================================  =========

The hyper-connection parameters keep flax's shapes (``dynamic_alpha_fn``
is (D, S+1), used as ``normed @ W``), so they need no transpose.

``transformer_from_flax`` does the same for the JAX TransformerMotionModel
(``models.transformer.TransformerMotionModel``):

=======================================================  ===============================  ==========================
flax path                                                torch key                        transform
=======================================================  ===============================  ==========================
pose_embed, time_embed_{0,1}, class_embed_{0,1},         same name .{weight,bias}         kernel.T
final_mod, final_layer
position_embed                                           position_embed                   none
class_embed/embedding                                    class_embed.weight               none
layer_i/MultiHeadDotProductAttention_0/{query,key,value} layers.i.attn.<name>             kernel (D, h, dh) -> (D, D).T,
                                                                                          bias (h, dh) -> (D,)
layer_i/MultiHeadDotProductAttention_0/out               layers.i.attn.out                kernel (h, dh, D) -> (D, D).T
layer_i/Dense_{0,1}                                      layers.i.ff.dense_{0,1}          kernel.T
layer_i/LayerNorm_{0,1}/{scale,bias} (post-norm layers)  layers.i.norm_{0,1}.{weight,bias} none
layer_i/adaln_mod                                        layers.i.adaln_mod               kernel.T
=======================================================  ===============================  ==========================

The flax projections' head axis is the outer one of the flattened feature
axis (head-major), as the port's ``view(B, N, h, dh)`` reads it. The adaLN
layers' and the final modulation's LayerNorms have no parameters.

``decoder_from_flax`` does the same for the JAX TransformerDecoderMotionModel
(``models.transformer_decoder.TransformerDecoderMotionModel``):

=======================================================  ====================================  ==========================
flax path                                                torch key                             transform
=======================================================  ====================================  ==========================
input_process, embed_timestep_{0,1}, output_process      same name .{weight,bias}              kernel.T
seq_queries                                              seq_queries                           none
learned_time_embed/embedding                             learned_time_embed.weight             none
{conv_local,spatial_attn}/Conv_j/{kernel,bias}           <name>.convs.j.{weight,bias}          kernel.transpose(2, 1, 0)
dec_i/MultiHeadDotProductAttention_{0,1}/...             layers.i.{self,cross}_attn.<name>     as the MHA rows above
dec_i/LayerNorm_j/{scale,bias}                           layers.i.norm_j.{weight,bias}         none
dec_i/Dense_j/{kernel,bias}                              layers.i.dense_j.{weight,bias}        kernel.T
=======================================================  ====================================  ==========================

``value_function_from_flax`` does the same for the JAX ValueFunction
(``models.temporal_unet.ValueFunction``): ``Dense_0``, ``Dense_1`` are
``time_mlp.{0,1}``, ``Dense_2``, ``Dense_3`` are ``head.{0,1}`` (kernel.T),
``Conv_i`` is ``downsamples.i`` (kernel.transpose(2, 1, 0)), and each
``ResidualTemporalBlock_i`` maps as in the U-Net's table.
"""
from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(dict(v), path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


_DENSE = lambda a: a.T
_CONV1X1 = lambda a: a[0].T
_SAME = lambda a: a

_CONV_BLOCK = {"conv_kernel": ("weight", _SAME), "conv_bias": ("bias", _SAME),
               "gn_scale": ("gn_weight", _SAME), "gn_bias": ("gn_bias", _SAME)}
_LEAF = {"kernel": "weight", "bias": "bias"}

# (pattern over the flax path, torch key template, transform of a kernel)
_TABLE = [
    (r"Dense_(\d+)/(kernel|bias)", "time_mlp.{0}.{leaf}", _DENSE),
    (r"ResidualTemporalBlock_(\d+)/Conv1dBlock_(\d+)/(\w+)", "res_blocks.{0}.blocks.{1}.{block}", None),
    (r"ResidualTemporalBlock_(\d+)/Dense_0/(kernel|bias)", "res_blocks.{0}.time_dense.{leaf}", _DENSE),
    (r"ResidualTemporalBlock_(\d+)/Conv_0/(kernel|bias)", "res_blocks.{0}.residual.{leaf}", _CONV1X1),
    (r"PreNormResidualAttention_(\d+)/(g|b)", "attentions.{0}.{1}", _SAME),
    (r"PreNormResidualAttention_(\d+)/LinearAttention_0/Conv_0/(kernel)", "attentions.{0}.attn.to_qkv.{leaf}", _CONV1X1),
    (r"PreNormResidualAttention_(\d+)/LinearAttention_0/Conv_1/(kernel|bias)", "attentions.{0}.attn.to_out.{leaf}", _CONV1X1),
    (r"ConvTranspose_(\d+)/(kernel|bias)", "upsamples.{0}.{leaf}", lambda a: a[::-1].transpose(1, 2, 0)),
    (r"Conv1dBlock_0/(\w+)", "final_block.{block}", None),
]


def temporal_unet_from_flax(params_np: dict) -> "OrderedDict[str, torch.Tensor]":
    """Map a flax TemporalUnet param tree to the port's state dict."""
    tree = params_np.get("params", params_np)
    flat = _flatten(tree)
    n_up = len({m.group(1) for p in flat if (m := re.match(r"ConvTranspose_(\d+)/", p))})
    out = OrderedDict()
    for path, arr in flat.items():
        m = re.fullmatch(r"Conv_(\d+)/(kernel|bias)", path)
        if m:
            i, leaf = int(m.group(1)), m.group(2)
            if i < n_up:
                key, fn = f"downsamples.{i}.{_LEAF[leaf]}", (lambda a: a.transpose(2, 1, 0))
            else:
                key, fn = f"final_conv.{_LEAF[leaf]}", _CONV1X1
            out[key] = _tensor(fn(arr) if leaf == "kernel" else arr)
            continue
        for pattern, template, fn in _TABLE:
            m = re.fullmatch(pattern, path)
            if not m:
                continue
            groups = m.groups()
            leaf = groups[-1]
            if fn is None:  # a Conv1dBlock leaf
                name, fn = _CONV_BLOCK[leaf]
                key = template.format(*groups, block=name)
                out[key] = _tensor(fn(arr))
            else:
                key = template.format(*groups, leaf=_LEAF.get(leaf, leaf))
                out[key] = _tensor(fn(arr) if leaf == "kernel" else arr)
            break
        else:
            raise KeyError(f"no mapping for flax parameter {path!r}")
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


_NORM = {"scale": "weight", "bias": "bias"}
_MHA = "MultiHeadDotProductAttention_0"
_HEADS = lambda a: a.reshape(a.shape[0], -1).T   # flax MHA (D, h, dh) -> Linear (h*dh, D)
_HEADS_BIAS = lambda b: b.reshape(-1)
_OUT = lambda a: a.reshape(-1, a.shape[-1]).T     # flax MHA out (h, dh, D) -> Linear (D, h*dh)

# (pattern over the flax path, torch key template, transform of a Dense kernel[, of a bias])
_LOCAL_TABLE = [
    (r"(pose_embed|time_embed_0|time_embed_1|final_layer)/(kernel|bias)", "{0}.{leaf}", _DENSE),
    (r"(pos_emb)", "{0}", _SAME),
    (r"class_embed/(embedding)", "class_embed.weight", _SAME),
    (r"dynamic_pos_bias/Dense_(\d+)/(kernel|bias)", "dynamic_pos_bias.dense.{0}.{leaf}", _DENSE),
    (r"hc_(attn|ff|global)_(\d+)/norm/(scale)", "hc_{0}.{1}.norm.scale", _SAME),
    (r"hc_(attn|ff|global)_(\d+)/(\w+)", "hc_{0}.{1}.{2}", _SAME),
    (r"global_attn_(\d+)/LayerNorm_0/(scale|bias)", "global_attn.{0}.norm.{norm}", _SAME),
    (rf"global_attn_(\d+)/{_MHA}/(query|key|value)/(kernel|bias)",
     "global_attn.{0}.attn.{1}.{leaf}", _HEADS, _HEADS_BIAS),
    (rf"global_attn_(\d+)/{_MHA}/(out)/(kernel|bias)", "global_attn.{0}.attn.{1}.{leaf}", _OUT),
    (r"attn_(\d+)/LayerNorm_0/(scale|bias)", "attn.{0}.norm.{norm}", _SAME),
    (r"attn_(\d+)/Dense_0/(kernel)", "attn.{0}.to_qkv.weight", _DENSE),
    (r"attn_(\d+)/Dense_1/(kernel)", "attn.{0}.to_out.weight", _DENSE),
    (r"ff_(\d+)/LayerNorm_0/(scale|bias)", "ff.{0}.norm.{norm}", _SAME),
    (r"ff_(\d+)/Dense_0/(kernel)", "ff.{0}.proj_in.weight", _DENSE),
    (r"ff_(\d+)/Dense_1/(kernel)", "ff.{0}.proj_out.weight", _DENSE),
    (r"LayerNorm_0/(scale|bias)", "norm.{norm}", _SAME),
]


def _map_table(params_np: dict, table) -> "OrderedDict[str, torch.Tensor]":
    """Map every flax leaf through the first ``table`` entry whose pattern
    matches its path: (pattern, torch key template, transform of a kernel[,
    transform of a bias]). Raises ``KeyError`` on a path no entry maps."""
    tree = params_np.get("params", params_np)
    out = OrderedDict()
    for path, arr in _flatten(tree).items():
        for pattern, template, fn, *bias_fn in table:
            m = re.fullmatch(pattern, path)
            if not m:
                continue
            leaf = m.groups()[-1]
            key = template.format(*m.groups(), leaf=_LEAF.get(leaf, leaf),
                                  norm=_NORM.get(leaf, leaf))
            if leaf == "kernel":
                arr = fn(arr)
            elif leaf == "bias" and bias_fn:
                arr = bias_fn[0](arr)
            out[key] = _tensor(arr)
            break
        else:
            raise KeyError(f"no mapping for flax parameter {path!r}")
    return out


def local_transformer_from_flax(params_np: dict) -> "OrderedDict[str, torch.Tensor]":
    """Map a flax LocalTransformer param tree to the port's state dict."""
    return _map_table(params_np, _LOCAL_TABLE)


_TRANSFORMER_TABLE = [
    (r"(pose_embed|time_embed_[01]|class_embed_[01]|final_mod|final_layer)/(kernel|bias)",
     "{0}.{leaf}", _DENSE),
    (r"(position_embed)", "{0}", _SAME),
    (r"class_embed/(embedding)", "class_embed.weight", _SAME),
    (rf"layer_(\d+)/{_MHA}/(query|key|value)/(kernel|bias)", "layers.{0}.attn.{1}.{leaf}",
     lambda a: a.reshape(a.shape[0], -1).T, lambda b: b.reshape(-1)),
    (rf"layer_(\d+)/{_MHA}/(out)/(kernel|bias)", "layers.{0}.attn.{1}.{leaf}",
     lambda a: a.reshape(-1, a.shape[-1]).T),
    (r"layer_(\d+)/Dense_([01])/(kernel|bias)", "layers.{0}.ff.dense_{1}.{leaf}", _DENSE),
    (r"layer_(\d+)/LayerNorm_([01])/(scale|bias)", "layers.{0}.norm_{1}.{norm}", _SAME),
    (r"layer_(\d+)/(adaln_mod)/(kernel|bias)", "layers.{0}.{1}.{leaf}", _DENSE),
]


def transformer_from_flax(params_np: dict) -> "OrderedDict[str, torch.Tensor]":
    """Map a flax TransformerMotionModel param tree to the port's state dict."""
    return _map_table(params_np, _TRANSFORMER_TABLE)


_CONV = lambda a: a.transpose(2, 1, 0)  # flax (k, Cin, Cout) -> torch Conv1d (Cout, Cin, k)

_DECODER_TABLE = [
    (r"(input_process|embed_timestep_[01]|output_process)/(kernel|bias)", "{0}.{leaf}", _DENSE),
    (r"(seq_queries)", "{0}", _SAME),
    (r"learned_time_embed/(embedding)", "learned_time_embed.weight", _SAME),
    (r"(conv_local|spatial_attn)/Conv_([01])/(kernel|bias)", "{0}.convs.{1}.{leaf}", _CONV),
    (rf"dec_(\d+)/{_MHA}/(query|key|value)/(kernel|bias)", "layers.{0}.self_attn.{1}.{leaf}",
     _HEADS, _HEADS_BIAS),
    (rf"dec_(\d+)/{_MHA}/(out)/(kernel|bias)", "layers.{0}.self_attn.{1}.{leaf}", _OUT),
    (r"dec_(\d+)/MultiHeadDotProductAttention_1/(query|key|value)/(kernel|bias)",
     "layers.{0}.cross_attn.{1}.{leaf}", _HEADS, _HEADS_BIAS),
    (r"dec_(\d+)/MultiHeadDotProductAttention_1/(out)/(kernel|bias)",
     "layers.{0}.cross_attn.{1}.{leaf}", _OUT),
    (r"dec_(\d+)/LayerNorm_([012])/(scale|bias)", "layers.{0}.norm_{1}.{norm}", _SAME),
    (r"dec_(\d+)/Dense_([01])/(kernel|bias)", "layers.{0}.dense_{1}.{leaf}", _DENSE),
]


def decoder_from_flax(params_np: dict) -> "OrderedDict[str, torch.Tensor]":
    """Map a flax TransformerDecoderMotionModel param tree to the port's state dict."""
    return _map_table(params_np, _DECODER_TABLE)


_RTB = r"ResidualTemporalBlock_(\d+)"
_VALUE_TABLE = [
    (r"Dense_([01])/(kernel|bias)", "time_mlp.{0}.{leaf}", _DENSE),
    (r"Dense_2/(kernel|bias)", "head.0.{leaf}", _DENSE),
    (r"Dense_3/(kernel|bias)", "head.1.{leaf}", _DENSE),
    (r"Conv_(\d+)/(kernel|bias)", "downsamples.{0}.{leaf}", _CONV),
    (_RTB + r"/Conv1dBlock_(\d+)/conv_(kernel)", "res_blocks.{0}.blocks.{1}.weight", _SAME),
    (_RTB + r"/Conv1dBlock_(\d+)/conv_(bias)", "res_blocks.{0}.blocks.{1}.bias", _SAME),
    (_RTB + r"/Conv1dBlock_(\d+)/gn_(scale)", "res_blocks.{0}.blocks.{1}.gn_weight", _SAME),
    (_RTB + r"/Conv1dBlock_(\d+)/gn_(bias)", "res_blocks.{0}.blocks.{1}.gn_bias", _SAME),
    (_RTB + r"/Dense_0/(kernel|bias)", "res_blocks.{0}.time_dense.{leaf}", _DENSE),
    (_RTB + r"/Conv_0/(kernel|bias)", "res_blocks.{0}.residual.{leaf}", _CONV1X1),
]


def value_function_from_flax(params_np: dict) -> "OrderedDict[str, torch.Tensor]":
    """Map a flax ValueFunction param tree to the port's state dict."""
    return _map_table(params_np, _VALUE_TABLE)
