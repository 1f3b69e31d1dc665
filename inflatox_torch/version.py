"""Version information for inflatox_torch.

The bundle schema is shared with ``inflatox_tpu``: a
:class:`~inflatox_torch.compiler.CompiledModel` bundle written by either
package loads into the other.  Major.minor must match for a bundle to load;
patch is ignored (the reference's ABI rule, inflatox_version.rs:48-53).
"""

__version__ = "0.1.0"

# Schema version of serialized CompiledModel bundles — the same string as
# inflatox_tpu/version.py, so bundles cross between the two packages.
__schema_version__ = "1.0.0"


def schema_compatible(other: str) -> bool:
    """True if a bundle written with schema version ``other`` can be loaded
    (major+minor equal, patch ignored)."""
    ours = __schema_version__.split(".")
    theirs = str(other).split(".")
    return len(theirs) >= 2 and ours[0] == theirs[0] and ours[1] == theirs[1]
