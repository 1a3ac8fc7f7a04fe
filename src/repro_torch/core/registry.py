"""Named FGL method registry (counterpart of ``repro.core.registry``).

Every trainer the launcher exposes is a strategy composition of
:class:`~repro_torch.core.fedgl.FGLTrainer`, registered here under the name
the CLI uses::

    from repro_torch.core import registry
    trainer = registry.build("SpreadFGL", cfg, batch, num_servers=3)

Ported methods: ``FedGL``, ``SpreadFGL``, ``local``, ``fedavg_fusion``.
Resolving a name lazily imports the modules that define them, so importing
this module alone never pulls in the engine.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

Builder = Callable[..., Any]  # (cfg, batch, **kw) -> FGLTrainer

_BUILDERS: Dict[str, Builder] = {}


def register(name: str) -> Callable[[Builder], Builder]:
    """Decorator: expose ``builder(cfg, batch, **kw)`` under ``name``."""
    def deco(builder: Builder) -> Builder:
        if name in _BUILDERS and _BUILDERS[name] is not builder:
            raise ValueError(f"method {name!r} already registered")
        _BUILDERS[name] = builder
        return builder
    return deco


def _populate() -> None:
    # Stock methods self-register on import.
    import repro_torch.core.baselines   # noqa: F401
    import repro_torch.core.spreadfgl   # noqa: F401


def build(name: str, cfg, batch, **kw):
    """Construct the registered method ``name`` for (cfg, batch)."""
    _populate()
    try:
        builder = _BUILDERS[name]
    except KeyError:
        raise KeyError(f"unknown FGL method {name!r}; "
                       f"available: {', '.join(names())}") from None
    return builder(cfg, batch, **kw)


def names() -> tuple:
    """All registered method names (sorted)."""
    _populate()
    return tuple(sorted(_BUILDERS))
