"""Checkpoint save / resume (port of ``llm_np_cp_tpu/utils/checkpoint.py``).

The JAX package writes an Orbax checkpoint.  The port needs no package
for it: a checkpoint is a directory holding one file, ``state.pt``, the
state tree (dicts of tensors, Python ints, floats, strings and None:
params, the optimizer's ``{"count", "mu", "nu"}``, the step) written by
``torch.save`` with every tensor on the CPU, and read back by
``torch.load(weights_only=True)``.  Dtypes are kept, the quantized
leaves' int8 and packed int4 payloads and their scales included.

A write replaces an existing checkpoint atomically (Orbax's
``force=True``): the state goes to a temporary file in the directory,
which is flushed to disk and then renamed over ``state.pt``.

The file holds global arrays, so a checkpoint restores onto any mesh.
Under a mesh (``mesh=``, with the model's ``config``) every param-shaped
tree of the state (a dict holding ``"embed_tokens"`` and ``"layers"``:
the params and the optimizer's moments) is gathered first
(``parallel.sharding.gather_shards``) and rank 0 writes; a restore cuts
each such tree to this rank's shards (``local_shards``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import torch

STATE_FILE = "state.pt"


def _param_tree(x: Any) -> bool:
    return isinstance(x, dict) and "embed_tokens" in x and "layers" in x


def _map_param_trees(fn, state: Any) -> Any:
    if _param_tree(state):
        return fn(state)
    if isinstance(state, dict):
        return {k: _map_param_trees(fn, v) for k, v in state.items()}
    return state


def _to_host(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return x


def save_checkpoint(path: str | Path, state: dict[str, Any], *, mesh: Any = None,
                    config: Any = None) -> None:
    """Write ``state`` (a tree: params / opt_state / step) to the
    directory ``path``, replacing what is there.  Under ``mesh`` every
    rank calls it with its shards and ``config``; rank 0 writes the
    gathered state, and every rank returns once the file is in place."""
    if mesh is not None:
        import torch.distributed as dist

        from llm_np_cp_tpu_torch.parallel.sharding import gather_shards

        state = _map_param_trees(lambda t: gather_shards(t, config, mesh), state)
        if dist.get_rank() == 0:
            _write(Path(path), _to_host(state))
        del state
        dist.barrier()
        return
    _write(Path(path), _to_host(state))


def _write(path: Path, state: dict) -> None:
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f".{STATE_FILE}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path / STATE_FILE)
    finally:
        if tmp.exists():
            tmp.unlink()


def restore_checkpoint(path: str | Path, like: dict[str, Any] | None = None, *,
                       mesh: Any = None, config: Any = None) -> dict[str, Any]:
    """Read the state tree saved at ``path``.  Without ``like`` its
    tensors are on the CPU as saved.  ``like``: a target state (e.g. the
    current one): each tensor takes its counterpart's device and dtype,
    and a shape that differs raises.  Under ``mesh`` (with ``config``)
    ``like`` holds this rank's shards, and every param-shaped tree is cut
    to them before the comparison."""
    state = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
    if like is None:
        return state
    if mesh is not None:
        from llm_np_cp_tpu_torch.parallel.sharding import local_shards

        state = _map_param_trees(
            lambda t: local_shards(t, config, mesh.plan, mesh.coords), state)
    return _like(state, like, "state")


def _like(x: Any, like: Any, where: str) -> Any:
    if isinstance(like, dict):
        if not isinstance(x, dict) or x.keys() != like.keys():
            raise ValueError(f"checkpoint {where}: keys {sorted(x) if isinstance(x, dict) else x!r}"
                             f" differ from the target's {sorted(like)}")
        return {k: _like(x[k], like[k], f"{where}[{k!r}]") for k in like}
    if isinstance(like, torch.Tensor):
        if not isinstance(x, torch.Tensor) or x.shape != like.shape:
            got = tuple(x.shape) if isinstance(x, torch.Tensor) else x
            raise ValueError(f"checkpoint {where}: {got} where the target has "
                             f"{tuple(like.shape)}")
        return x.to(device=like.device, dtype=like.dtype)
    return x
