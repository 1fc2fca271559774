"""State checkpointing: pytree snapshots + scene-JSON interop.

Rebuild of the reference's checkpoint story (SURVEY.md section 5.4): scenes
are the checkpoints (storeScene/loadScene serialize every component,
resource.hpp:463-476), settings persist as JSON, and the pipeline cache
persists compiled artifacts. Equivalents here:

- `save`/`load`: the full engine state pytree as an .npz snapshot
  (exact-bitwise resume, including physics warm-start impulses).
- scene JSON via garden_tpu.scene (human-readable interop, reference format).
- compiled-function cache via jax's persistent compilation cache
  (garden_tpu.utils.compile_cache).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

SEP = "\x1f"


def _key_str(path) -> str:
    return jax.tree_util.keystr(path)


def _flatten(state: Any) -> Tuple[Dict[str, np.ndarray], List[str], Any]:
    leaves_kp, treedef = jax.tree_util.tree_flatten_with_path(state)
    flat = {f"leaf_{i}": np.asarray(x) for i, (_, x) in enumerate(leaves_kp)}
    keys = [_key_str(kp) for kp, _ in leaves_kp]
    return flat, keys, treedef


def save(path: str, state: Any) -> None:
    """Snapshot a state pytree to .npz (+ structure file with per-leaf key
    paths, validated at load)."""
    flat, keys, treedef = _flatten(state)
    base = path[:-4] if path.endswith(".npz") else path
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    np.savez_compressed(base + ".npz", **flat)
    with open(base + ".npz.tree", "w", encoding="utf-8") as f:
        f.write("\n".join([str(len(keys))] + keys))


def load(path: str, like: Any) -> Any:
    """Restore a snapshot; `like` provides the pytree structure, which is
    validated leaf-by-leaf against the persisted key paths so a structurally
    different `like` errors instead of silently mis-mapping arrays."""
    base = path[:-4] if path.endswith(".npz") else path
    data = np.load(base + ".npz")
    leaves_kp, treedef = jax.tree_util.tree_flatten_with_path(like)
    keys = [_key_str(kp) for kp, _ in leaves_kp]
    try:
        with open(base + ".npz.tree", "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
        saved_n, saved_keys = int(lines[0]), lines[1:]
    except (OSError, ValueError, IndexError):
        saved_n, saved_keys = len(keys), None  # legacy sidecar: count only
    if saved_n != len(keys):
        raise ValueError(
            f"checkpoint has {saved_n} leaves but `like` has {len(keys)}")
    if saved_keys is not None and saved_keys != keys:
        diff = next((i, a, b) for i, (a, b)
                    in enumerate(zip(saved_keys, keys)) if a != b)
        raise ValueError(
            f"checkpoint structure mismatch at leaf {diff[0]}: "
            f"saved {diff[1]!r} vs requested {diff[2]!r}")
    restored = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(keys))]
    return jax.tree_util.tree_unflatten(treedef, restored)


def debug_guards(enable: bool = True) -> None:
    """NaN/Inf guards (the validation-layer analog, SURVEY.md 5.2)."""
    jax.config.update("jax_debug_nans", enable)
    jax.config.update("jax_debug_infs", enable)
