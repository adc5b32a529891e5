"""The JAX side of the repository must not load in a benchmark process."""

from __future__ import annotations

import sys

#: top-level module names that no benchmark process may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "eeg_image_decode_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded top-level names in :data:`FORBIDDEN`, compared whole (the
    part before the first dot): ``eeg_image_decode_tpu_torch`` is not
    ``eeg_image_decode_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names}
                  & set(FORBIDDEN))


def check(where: str) -> None:
    """Raise, naming the modules on standard error, if any is loaded."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded {where}: {found}", file=sys.stderr)
        raise SystemExit(3)
