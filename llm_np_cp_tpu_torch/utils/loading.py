"""HF checkpoint loading: sharded safetensors → the port's param dict
(port of ``llm_np_cp_tpu/utils/loading.py``).

The port reads safetensors itself (no ``safetensors`` package, no
download): a file is an 8-byte little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` and the raw
tensor bytes, which are memory-mapped and viewed with numpy.  BF16 is read
as ``int16`` and viewed as ``torch.bfloat16``.  Tensors are copied into
preallocated stacked ``[num_layers, ...]`` buffers on ``device``
(projections transposed to (in, out) on the way) with the family key maps
of ``models/{llama,gemma2,qwen2}.py``.
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

from llm_np_cp_tpu_torch.config import ModelConfig
from llm_np_cp_tpu_torch.device import resolve_device
from llm_np_cp_tpu_torch.models import gemma2, llama, qwen2
from llm_np_cp_tpu_torch.models.transformer import param_shapes

_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")

# safetensors dtype → (numpy storage dtype, torch dtype it is viewed as)
_DTYPES: dict[str, tuple[np.dtype, torch.dtype]] = {
    "BF16": (np.dtype("<i2"), torch.bfloat16),
    "F16": (np.dtype("<f2"), torch.float16),
    "F32": (np.dtype("<f4"), torch.float32),
    "F64": (np.dtype("<f8"), torch.float64),
    "I8": (np.dtype("i1"), torch.int8),
    "U8": (np.dtype("u1"), torch.uint8),
    "I32": (np.dtype("<i4"), torch.int32),
    "I64": (np.dtype("<i8"), torch.int64),
    "BOOL": (np.dtype("?"), torch.bool),
}


class SafetensorsFile:
    """A memory-mapped safetensors file: ``keys()`` and ``get_tensor``."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        with open(self.path, "rb") as f:
            raw = f.read(8)
            if len(raw) != 8:
                raise ValueError(f"{self.path.name}: truncated safetensors header")
            (n,) = struct.unpack("<Q", raw)
            size = self.path.stat().st_size
            if n > size - 8:
                raise ValueError(f"{self.path.name}: header length {n} exceeds file size {size}")
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.header: dict[str, dict] = header
        self._base = 8 + n
        data_len = size - self._base
        self._data = (
            np.memmap(self.path, dtype=np.uint8, mode="r", offset=self._base, shape=(data_len,))
            if data_len > 0 else np.zeros(0, np.uint8)
        )

    def keys(self) -> list[str]:
        return list(self.header)

    def get_tensor(self, key: str) -> torch.Tensor:
        """The tensor ``key`` as a CPU torch tensor (a copy)."""
        meta = self.header[key]
        if meta["dtype"] not in _DTYPES:
            raise ValueError(f"{self.path.name}: {key}: unsupported dtype {meta['dtype']}")
        np_dtype, t_dtype = _DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * np_dtype.itemsize or end > self._data.shape[0]:
            raise ValueError(f"{self.path.name}: {key}: data_offsets {begin}..{end} do not fit {shape}")
        arr = np.frombuffer(self._data, dtype=np_dtype, count=count, offset=begin).reshape(shape)
        t = torch.from_numpy(arr.copy())
        return t.view(t_dtype) if t.dtype != t_dtype else t


def _key_maps(config: ModelConfig):
    family = {"gemma2": gemma2, "qwen2": qwen2}.get(config.model_type, llama)
    return family.LAYER_KEY_MAP, family.TOP_KEY_MAP


def shard_files(model_dir: str | Path) -> list[Path]:
    """Checkpoint shards: the index file first, single-file fallback."""
    model_dir = Path(model_dir)
    index = model_dir / "model.safetensors.index.json"
    if index.exists():
        with open(index) as f:
            weight_map: dict[str, str] = json.load(f)["weight_map"]
        return [model_dir / fn for fn in sorted(set(weight_map.values()))]
    single = model_dir / "model.safetensors"
    if single.exists():
        return [single]
    raise FileNotFoundError(f"no model.safetensors.index.json or model.safetensors in {model_dir}")


def load_params(
    model_dir: str | Path,
    config: ModelConfig | None = None,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> tuple[dict[str, Any], ModelConfig]:
    """Load an HF checkpoint directory into the port's param dict on
    ``device`` (bfloat16 by default; float32 for parity runs).
    Returns (params, config)."""
    dev = resolve_device(device)
    model_dir = Path(model_dir)
    if config is None:
        config = ModelConfig.from_json(model_dir / "config.json")
    layer_map, top_map = _key_maps(config)
    shapes = param_shapes(config)

    def empty(shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    params: dict[str, Any] = {
        "embed_tokens": empty(shapes["embed_tokens"]),
        "final_norm": empty(shapes["final_norm"]),
        "layers": {name: empty(shape) for name, shape in shapes["layers"].items()},
    }
    if "lm_head" in shapes:
        params["lm_head"] = empty(shapes["lm_head"])
    filled: set[str] = set()

    def fill(f: SafetensorsFile, key: str, dest: torch.Tensor, transpose: bool) -> None:
        value = f.get_tensor(key)
        if transpose:
            value = value.T
        if tuple(dest.shape) != tuple(value.shape):
            raise ValueError(
                f"{f.path.name}: {key}: checkpoint shape {tuple(value.shape)} "
                f"!= expected {tuple(dest.shape)}"
            )
        dest.copy_(value.to(dtype))

    for path in shard_files(model_dir):
        f = SafetensorsFile(path)
        for key in f.keys():
            m = _LAYER_RE.match(key)
            if m:
                idx, suffix = int(m.group(1)), m.group(2)
                if suffix not in layer_map:
                    continue  # e.g. rotary inv_freq buffers
                name, transpose = layer_map[suffix]
                if name not in params["layers"]:
                    if name.endswith("_bias"):
                        # a bias the config gates off but the checkpoint
                        # carries would be silently dropped
                        raise ValueError(
                            f"{key}: checkpoint carries this bias but the config "
                            f"disables it (attention_bias={config.attention_bias}, "
                            f"attention_out_bias={config.attention_out_bias}, "
                            f"mlp_bias={config.mlp_bias})"
                        )
                    continue
                fill(f, key, params["layers"][name][idx], transpose)
                filled.add(f"layers.{name}.{idx}")
            elif key in top_map:
                name, transpose = top_map[key]
                if name == "lm_head" and config.tie_word_embeddings:
                    continue  # tied: forward reuses embed_tokens
                if name not in params:
                    continue
                fill(f, key, params[name], transpose)
                filled.add(name)

    _check_complete(params, filled, config)
    return params, config


def _check_complete(params: dict, filled: set, config: ModelConfig) -> None:
    missing: list[str] = []
    for name in params:
        if name == "layers":
            for lname in params["layers"]:
                for i in range(config.num_hidden_layers):
                    if f"layers.{lname}.{i}" not in filled:
                        missing.append(f"model.layers.{i}.<{lname}>")
        elif name not in filled:
            missing.append(name)
    if missing:
        preview = ", ".join(missing[:6])
        raise ValueError(
            f"checkpoint incomplete: {len(missing)} tensors missing ({preview}"
            + (", ..." if len(missing) > 6 else "") + ")"
        )
