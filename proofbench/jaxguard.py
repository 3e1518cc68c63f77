"""The check that the process that prints a result holds neither JAX nor
the JAX package.  Names are compared by their top-level part, whole:
`gemini_tpu_torch.fields` is the port, `gemini_tpu.fields` is not."""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "gemini_tpu")


def forbidden(names: Iterable[str]) -> List[str]:
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
