"""Model zoo of the port.

``get_family(name)`` resolves a model family by the config's ``model_name``
key, as ``dstagnn_drought_tpu/models/__init__.py`` does. Every family module
exposes the same surface:

* ``make_model(spec, adj_merge, adj_pa, *, seed, device) -> (model, constants)``
  (the constants: ``cheb_polys`` and ``adj_pa``);
* the model's forward, with the keyword set ``training/step.py`` passes;
* ``params_from_jax(params, spec) -> state_dict``.

Families: ``dstagnn`` (the flagship) and ``astgcn``, ``mstgcn``, ``stgcn``,
``transformer``.
"""
import importlib

_FAMILIES = ("dstagnn", "astgcn", "mstgcn", "stgcn", "transformer")


def get_family(name: str):
    """The family module of ``name`` (case-insensitive)."""
    key = name.lower()
    if key not in _FAMILIES:
        raise ValueError(
            f"unknown model family {name!r}; available: {', '.join(_FAMILIES)}"
        )
    return importlib.import_module(f"dstagnn_drought_tpu_torch.models.{key}")
