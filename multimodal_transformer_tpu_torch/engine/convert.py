"""Between the reference's `.pth` key layout and the port's `state_dict`.

Counterpart of `multimodal_transformer_tpu/engine/convert.py`.  The
reference saves `{modalities, mod_dimension, window_size, model}` with
`model` its torch state_dict (reference MFT/train.py:345-347); the port's
parameters are the JAX package's tree flattened with "." (utils/params.py),
in the same torch layout, so every tensor copies over unchanged and only the
keys are translated:

  reference                              port
  -----------------------------------   -----------------------------------
  Transformer.embed.1.weight  (Sequential(Dropout, Linear, ReLU) embed)
                                        Transformer.embed.weight
  Transformer.decoder.weight_ih_l0      Transformer.decoder.weight_ih
  Transformer.dec_h0 [1, 1, H]          Transformer.dec_h0 [1, H]
  Transformer.out.0 / out.2             Transformer.out_fc1 / out_fc2
  LSTM.embed.1 / attn.0 / attn.2 /      LSTM.embed / attn_fc1 / attn_fc2 /
  lstm.*_l0 / decoder.0 / decoder.{2,3}   lstm.* / decoder_fc1 / decoder_fc2

and the rest (front ends, encoders, MFN) by the same names.  Reference
entries that never run (the standalone attn{mod}/ff{mod} modules, reference
multiTransformer.py:273-276) are ignored.  `convert_pth` restores the
configuration from the file's metadata and detects B1-LSTM's legacy variant
(an embed 128 wide) and the acoustic window embed (the conv's width).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models import ModelConfig, build_model
from ..models.config import default_config
from ..utils.params import flatten_tree, unflatten_tree


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def port_tree(cfg: ModelConfig):
    """The nested tree of the port's parameters for cfg (shapes only: the
    values are zeros)."""
    with torch.device("meta"):
        module = build_model(cfg)
    return unflatten_tree({k: np.zeros(tuple(v.shape), np.float32)
                           for k, v in module.state_dict().items()})


def _map_encoder(prefix: str, enc_params, state):
    for i, layer in enumerate(enc_params["layers"]):
        lp = f"{prefix}.layers.{i}"
        for j in range(4):
            layer["self_attn"]["linears"][j] = {
                "weight": state[f"{lp}.self_attn.linears.{j}.weight"],
                "bias": state[f"{lp}.self_attn.linears.{j}.bias"],
            }
        for wname in ("w_1", "w_2"):
            layer["feed_forward"][wname] = {
                "weight": state[f"{lp}.feed_forward.{wname}.weight"],
                "bias": state[f"{lp}.feed_forward.{wname}.bias"],
            }
        for k in range(2):
            layer["sublayer"][k]["norm"] = {
                "a_2": state[f"{lp}.sublayer.{k}.norm.a_2"],
                "b_2": state[f"{lp}.sublayer.{k}.norm.b_2"],
            }
    enc_params["norm"] = {"a_2": state[f"{prefix}.norm.a_2"],
                          "b_2": state[f"{prefix}.norm.b_2"]}


def _map_linear(dst: Dict, state, key: str):
    dst["weight"] = state[f"{key}.weight"]
    dst["bias"] = state[f"{key}.bias"]


def _map_lstm(dst: Dict, state, key: str, suffix: str = ""):
    for p in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        dst[p] = state[f"{key}.{p}{suffix}"]


def _map_frontend(params, state, mods):
    for m in mods:
        params[f"cnn_{m}"]["conv1d"] = {
            "weight": state[f"cnn_{m}.conv1d.weight"],
            "bias": state[f"cnn_{m}.conv1d.bias"],
        }
        for lin in ("linear_projection", "linear_gate"):
            _map_linear(params[f"highway_{m}"][lin], state,
                        f"highway_{m}.{lin}")


def _map_uni_head(head, state, prefix: str, embed_is_mlp: bool):
    embed_key = f"{prefix}.embed.1" if embed_is_mlp else f"{prefix}.embed"
    _map_linear(head["embed"], state, embed_key)
    _map_encoder(f"{prefix}.encoder", head["encoder"], state)
    if "decoder" in head:
        _map_lstm(head["decoder"], state, f"{prefix}.decoder", "_l0")
        head["dec_h0"] = state[f"{prefix}.dec_h0"].reshape(1, -1)
        head["dec_c0"] = state[f"{prefix}.dec_c0"].reshape(1, -1)
    _map_linear(head["out_fc1"], state, f"{prefix}.out.0")
    _map_linear(head["out_fc2"], state, f"{prefix}.out.2")


MFN_LINEARS = ("att1_fc1", "att1_fc2", "att2_fc1", "att2_fc2", "gamma1_fc1",
               "gamma1_fc2", "gamma2_fc1", "gamma2_fc2", "out_fc1", "out_fc2")


def _map_mfn(mfn, state, prefix: str, mods):
    for m in mods:
        _map_lstm(mfn[f"lstm_{m}"], state, f"{prefix}.lstm_{m}")
    for k in MFN_LINEARS:
        _map_linear(mfn[k], state, f"{prefix}.{k}")


def convert_state_dict(cfg: ModelConfig,
                       state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A reference state_dict (numpy values) -> the port's state_dict keys
    for cfg (float32 numpy values)."""
    state = {k: _np(v) for k, v in state.items()}
    params = port_tree(cfg)
    mods = cfg.modalities
    _map_frontend(params, state, mods)

    fam = cfg.family
    multimodal = len(mods) > 1
    if fam == "B1-LSTM":
        head = params["LSTM"]
        _map_linear(head["embed"], state, "LSTM.embed.1")
        _map_linear(head["attn_fc1"], state, "LSTM.attn.0")
        _map_linear(head["attn_fc2"], state, "LSTM.attn.2")
        _map_lstm(head["lstm"], state, "LSTM.lstm", "_l0")
        _map_linear(head["decoder_fc1"], state, "LSTM.decoder.0")
        final = ("LSTM.decoder.3" if "LSTM.decoder.3.weight" in state
                 else "LSTM.decoder.2")
        _map_linear(head["decoder_fc2"], state, final)
    elif fam == "B2-Trans":
        _map_uni_head(params["Transformer"], state, "Transformer",
                      embed_is_mlp=False)
    elif fam == "SFT":
        if multimodal:
            _map_linear(params["fusionLayer"], state, "fusionLayer")
            _map_uni_head(params["Transformer"], state, "Transformer",
                          embed_is_mlp=True)
        else:
            if "fusionLayer.weight" in state:
                _map_linear(params["fusionLayer"], state, "fusionLayer")
            _map_uni_head(params["Transformer"], state, "Transformer",
                          embed_is_mlp=False)
    elif fam in ("MFT", "B3-MFN"):
        head = params["Transformer"]
        if multimodal:
            for m in mods:
                _map_linear(head[f"embed_{m}"], state, f"Transformer.embed_{m}")
                if fam == "MFT":
                    _map_encoder(f"Transformer.transformer_{m}",
                                 head[f"transformer_{m}"], state)
            _map_mfn(head["mfn"], state, "Transformer.mfn", mods)
        else:
            _map_uni_head(head, state, "Transformer", embed_is_mlp=False)
    else:
        raise ValueError(f"unknown family {fam}")
    return flatten_tree(params)


def export_state_dict(cfg: ModelConfig, port_state) -> Dict[str, np.ndarray]:
    """Inverse of convert_state_dict: the port's state_dict -> the
    reference's key layout (float32 numpy values)."""
    params = unflatten_tree({k: _np(v) for k, v in port_state.items()})
    state: Dict[str, np.ndarray] = {}
    mods = cfg.modalities

    def put_linear(key, p):
        state[f"{key}.weight"] = p["weight"]
        state[f"{key}.bias"] = p["bias"]

    def put_lstm(key, p, suffix=""):
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            state[f"{key}.{name}{suffix}"] = p[name]

    def put_encoder(prefix, enc):
        for i, layer in enumerate(enc["layers"]):
            lp = f"{prefix}.layers.{i}"
            for j in range(4):
                put_linear(f"{lp}.self_attn.linears.{j}",
                           layer["self_attn"]["linears"][j])
            for w in ("w_1", "w_2"):
                put_linear(f"{lp}.feed_forward.{w}", layer["feed_forward"][w])
            for k in range(2):
                state[f"{lp}.sublayer.{k}.norm.a_2"] = \
                    layer["sublayer"][k]["norm"]["a_2"]
                state[f"{lp}.sublayer.{k}.norm.b_2"] = \
                    layer["sublayer"][k]["norm"]["b_2"]
        state[f"{prefix}.norm.a_2"] = enc["norm"]["a_2"]
        state[f"{prefix}.norm.b_2"] = enc["norm"]["b_2"]

    def put_uni_head(prefix, head, embed_is_mlp):
        put_linear(f"{prefix}.embed.1" if embed_is_mlp else f"{prefix}.embed",
                   head["embed"])
        put_encoder(f"{prefix}.encoder", head["encoder"])
        if "decoder" in head:
            put_lstm(f"{prefix}.decoder", head["decoder"], "_l0")
            state[f"{prefix}.dec_h0"] = head["dec_h0"].reshape(1, 1, -1)
            state[f"{prefix}.dec_c0"] = head["dec_c0"].reshape(1, 1, -1)
        put_linear(f"{prefix}.out.0", head["out_fc1"])
        put_linear(f"{prefix}.out.2", head["out_fc2"])

    for m in mods:
        state[f"cnn_{m}.conv1d.weight"] = params[f"cnn_{m}"]["conv1d"]["weight"]
        state[f"cnn_{m}.conv1d.bias"] = params[f"cnn_{m}"]["conv1d"]["bias"]
        for lin in ("linear_projection", "linear_gate"):
            put_linear(f"highway_{m}.{lin}", params[f"highway_{m}"][lin])

    fam = cfg.family
    multimodal = len(mods) > 1
    if fam == "B1-LSTM":
        head = params["LSTM"]
        put_linear("LSTM.embed.1", head["embed"])
        put_linear("LSTM.attn.0", head["attn_fc1"])
        put_linear("LSTM.attn.2", head["attn_fc2"])
        put_lstm("LSTM.lstm", head["lstm"], "_l0")
        put_linear("LSTM.decoder.0", head["decoder_fc1"])
        final = ("LSTM.decoder.2" if cfg.variant == "legacy"
                 else "LSTM.decoder.3")
        put_linear(final, head["decoder_fc2"])
    elif fam == "B2-Trans":
        put_uni_head("Transformer", params["Transformer"], False)
    elif fam == "SFT":
        put_linear("fusionLayer", params["fusionLayer"])
        put_uni_head("Transformer", params["Transformer"], multimodal)
    elif fam in ("MFT", "B3-MFN"):
        head = params["Transformer"]
        if multimodal:
            for m in mods:
                put_linear(f"Transformer.embed_{m}", head[f"embed_{m}"])
                if fam == "MFT":
                    put_encoder(f"Transformer.transformer_{m}",
                                head[f"transformer_{m}"])
            for m in mods:
                put_lstm(f"Transformer.mfn.lstm_{m}", head["mfn"][f"lstm_{m}"])
            for k in MFN_LINEARS:
                put_linear(f"Transformer.mfn.{k}", head["mfn"][k])
        else:
            put_uni_head("Transformer", head, False)
    return state


def detect_config(family: str, meta: dict, state: Dict[str, np.ndarray], *,
                  mask_mode: str = "query") -> ModelConfig:
    """The configuration of a checkpoint: family and modalities, mod_dimension
    and window_size from its metadata; B1-LSTM's legacy variant (an embed
    128 wide) and the acoustic window embed (the conv's width) from its
    weights.  state: either key layout (the embed and conv keys are the
    same in both)."""
    variant = "default"
    embed = state.get("LSTM.embed.1.weight", state.get("LSTM.embed.weight"))
    if family == "B1-LSTM" and embed is not None and embed.shape[0] == 128:
        variant = "legacy"
    acoustic_embed = 88
    if "cnn_acoustic.conv1d.weight" in state:
        acoustic_embed = int(state["cnn_acoustic.conv1d.weight"].shape[0])
    cfg = default_config(family, list(meta["modalities"]),
                         acoustic_embed=acoustic_embed, mask_mode=mask_mode,
                         variant=variant)
    object.__setattr__(cfg, "mod_dimension",
                       {k: int(v) for k, v in meta["mod_dimension"].items()})
    object.__setattr__(cfg, "window_size",
                       {k: int(v) for k, v in meta["window_size"].items()})
    return cfg


def convert_pth(path: str, family: str, mask_mode: str = "query"):
    """Load a reference-layout .pth; returns (cfg, port state_dict)."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    state = {k: _np(v) for k, v in ck["model"].items()}
    meta = {"modalities": list(ck["modalities"]),
            "mod_dimension": dict(ck["mod_dimension"]),
            "window_size": dict(ck["window_size"])}
    cfg = detect_config(family, meta, state, mask_mode=mask_mode)
    return cfg, convert_state_dict(cfg, state)
