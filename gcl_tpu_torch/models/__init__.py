"""models subpackage of gcl_tpu_torch (mirrors gcl_tpu/models).

The registry follows gcl_tpu's rule: every public class of the model
modules whose name holds 'Net', 'MLP' or 'Head'. ``load_model(name)``
returns the class registered under ``name`` and raises for any other.
"""
from . import mlp, projection_head, resunet, simpleunet


def _registered(module):
    return [getattr(module, a) for a in dir(module)
            if ("Net" in a or "MLP" in a or "Head" in a)
            and not a.startswith("_")]


MODELS = tuple(m for module in (simpleunet, resunet, mlp, projection_head)
               for m in _registered(module))


def load_model(name: str):
    """The model class registered under ``name``; an unknown name
    raises."""
    mdict = {m.__name__: m for m in MODELS}
    if name not in mdict:
        raise ValueError(f"model {name!r} is not registered: the models are "
                         f"{sorted(mdict)}")
    return mdict[name]
