"""models subpackage of gcl_tpu_torch (mirrors gcl_tpu/models).

``load_model(name)`` looks a model class up by name, as gcl_tpu's
registry does, among the classes ported so far.
"""
from .resunet import ResUNetFatBN, ResUNetFatBNEXP

MODELS = (ResUNetFatBN, ResUNetFatBNEXP)


def load_model(name: str):
    """The model class registered under ``name``. gcl_tpu registers more
    (the rest of the ResUNet zoo, the IN variants, SimpleUNet, the MLPs
    and heads): those are not ported yet (ROADMAP Queue 1 item 5), and
    asking for one, or for an unknown name, raises."""
    mdict = {m.__name__: m for m in MODELS}
    if name not in mdict:
        raise ValueError(
            f"model {name!r} is not in gcl_tpu_torch: it has "
            f"{sorted(mdict)} (the rest of gcl_tpu's model zoo is ROADMAP "
            f"Queue 1 item 5)")
    return mdict[name]
