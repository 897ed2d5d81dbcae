"""Safetensors files and HF `config.json`, read and written without the
`safetensors` and `transformers` packages (the port's converters run on
machines that have neither).

The format: an 8-byte little-endian header length N, a JSON header of N
bytes ({name: {"dtype", "shape", "data_offsets": [begin, end]}, and an
optional "__metadata__"}), then the raw tensor bytes, offsets counted
from the end of the header. A sharded checkpoint names each tensor's
file in `model.safetensors.index.json` ("weight_map").
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from types import SimpleNamespace
from typing import Mapping

import torch

INDEX_NAME = "model.safetensors.index.json"
SINGLE_NAME = "model.safetensors"

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_header(path: str):
    """(header dict without "__metadata__", byte offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class LazySafetensorsDict(Mapping):
    """Read-on-demand mapping over an HF safetensors checkpoint, a single
    `model.safetensors` or shards named by the index. Each access
    returns a tensor over a private mmap of its file (no copy until
    written to), so conversion touches one tensor at a time."""

    def __init__(self, hf_dir: str):
        index = os.path.join(hf_dir, INDEX_NAME)
        if os.path.isfile(index):
            with open(index) as f:
                files = {k: os.path.join(hf_dir, v)
                         for k, v in json.load(f)["weight_map"].items()}
        else:
            single = os.path.join(hf_dir, SINGLE_NAME)
            if not os.path.isfile(single):
                raise FileNotFoundError(
                    f"no safetensors checkpoint under {hf_dir}")
            files = dict.fromkeys(read_header(single)[0], single)
        self._files = files
        self._open: dict = {}  # path -> (header, data offset, mmap)

    def _file(self, path):
        if path not in self._open:
            header, start = read_header(path)
            with open(path, "rb") as f:
                # ACCESS_COPY: a writable private mapping, which
                # torch.frombuffer takes without a warning
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
            self._open[path] = (header, start, mm)
        return self._open[path]

    def __getitem__(self, name: str) -> torch.Tensor:
        header, start, mm = self._file(self._files[name])
        info = header[name]
        dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = info["shape"]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        flat = torch.frombuffer(mm, dtype=dtype, offset=start + begin,
                                count=(end - begin) // dtype.itemsize)
        return flat.reshape(shape)

    def __iter__(self):
        return iter(self._files)

    def __len__(self):
        return len(self._files)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Mapping[str, str] = None) -> int:
    """Write `tensors` (any device, any strides) as one safetensors file,
    each moved to the host as it is written. Returns the bytes written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + _nbytes(t)]}
        offset += _nbytes(t)
    header["__metadata__"] = dict(metadata or {"format": "pt"})
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                host = t.detach().to("cpu").contiguous().reshape(-1)
                f.write(memoryview(host.view(torch.uint8).numpy()))
        f.flush()
        os.fsync(f.fileno())
    return 8 + len(raw) + offset


def save_sharded(tensors: Mapping[str, torch.Tensor], out_dir: str,
                 max_shard_bytes: int = 5 * 10**9) -> int:
    """Write `tensors` into `out_dir` as HF does: `model.safetensors`
    when they fit one shard, else `model-0000i-of-0000n.safetensors`
    shards of at most `max_shard_bytes` (a larger tensor alone) and the
    index. Returns the bytes written."""
    os.makedirs(out_dir, exist_ok=True)
    shards, size = [[]], 0
    for name, t in tensors.items():
        if shards[-1] and size + _nbytes(t) > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(name)
        size += _nbytes(t)
    if len(shards) == 1:
        return save_file(tensors, os.path.join(out_dir, SINGLE_NAME))
    written, weight_map = 0, {}
    for i, names in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        written += save_file({k: tensors[k] for k in names},
                             os.path.join(out_dir, fname))
        weight_map.update(dict.fromkeys(names, fname))
    total = sum(_nbytes(t) for t in tensors.values())
    with open(os.path.join(out_dir, INDEX_NAME), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    return written


# ---------------------------------------------------------------------------
# config.json
# ---------------------------------------------------------------------------

# transformers' class defaults: its save_pretrained writes only the
# fields that differ from them
_HF_DEFAULTS = {
    "llama": dict(vocab_size=32000, hidden_size=4096,
                  intermediate_size=11008, num_hidden_layers=32,
                  num_attention_heads=32, num_key_value_heads=None,
                  max_position_embeddings=2048, rms_norm_eps=1e-6,
                  rope_theta=10000.0, tie_word_embeddings=False),
    "falcon": dict(vocab_size=65024, hidden_size=4544,
                   num_hidden_layers=32, num_attention_heads=71,
                   num_kv_heads=None, layer_norm_epsilon=1e-5,
                   multi_query=True, new_decoder_architecture=False,
                   parallel_attn=True, bias=False, alibi=False,
                   rope_theta=10000.0, max_position_embeddings=2048,
                   tie_word_embeddings=True),
}


def read_hf_config(hf_dir: str) -> SimpleNamespace:
    """`config.json` of an HF Llama or Falcon directory with
    transformers' defaults filled in (what AutoConfig.from_pretrained
    gives for the fields the converters read)."""
    with open(os.path.join(hf_dir, "config.json")) as f:
        raw = json.load(f)
    model_type = raw.get("model_type")
    if model_type not in _HF_DEFAULTS:
        raise ValueError(f"{hf_dir}/config.json: model_type {model_type!r}"
                         f" is not one of {sorted(_HF_DEFAULTS)}")
    cfg = {**_HF_DEFAULTS[model_type], **raw}
    for kv in ("num_key_value_heads", "num_kv_heads"):
        if kv in cfg and cfg[kv] is None:
            cfg[kv] = cfg["num_attention_heads"]
    return SimpleNamespace(**cfg)


def write_hf_config(hf_dir: str, fields: dict) -> None:
    os.makedirs(hf_dir, exist_ok=True)
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump(fields, f, indent=2, sort_keys=True)


def llama_hf_config(cfg, vocab_size: int, dtype: torch.dtype) -> dict:
    """The LlamaConfig fields of a native Llama config."""
    return dict(
        architectures=["LlamaForCausalLM"], model_type="llama",
        vocab_size=vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.ffn_hidden_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_attention_heads_kv,
        max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.layernorm_epsilon, rope_theta=cfg.rope_theta,
        hidden_act="silu", tie_word_embeddings=False, attention_bias=False,
        mlp_bias=False, torch_dtype=str(dtype).replace("torch.", ""))


def falcon_hf_config(cfg, vocab_size: int, dtype: torch.dtype) -> dict:
    """The FalconConfig fields of a native Falcon config."""
    return dict(
        architectures=["FalconForCausalLM"], model_type="falcon",
        vocab_size=vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_kv_heads=cfg.num_attention_heads_kv,
        new_decoder_architecture=cfg.parallel_layernorm,
        multi_query=cfg.num_attention_heads_kv == 1, parallel_attn=True,
        bias=False, alibi=False, rope_theta=cfg.rope_theta,
        layer_norm_epsilon=cfg.layernorm_epsilon,
        max_position_embeddings=cfg.max_position_embeddings,
        tie_word_embeddings=True,
        torch_dtype=str(dtype).replace("torch.", ""))
