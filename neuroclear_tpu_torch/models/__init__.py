"""The model registry, the port of ``neuroclear_tpu/models/__init__.py``:
``--model foo_bar`` -> module ``neuroclear_tpu_torch.models.foo_bar_model``,
class ``FooBarModel`` (matched case-insensitively, a subclass of
``BaseModel``).  The ported training models are ``PORTED``; any other name
is refused with a pointer to ROADMAP.md.  ``test_model`` holds the
inference model and checkpoint loading of ``test_dice``."""

from __future__ import annotations

import importlib

PORTED = ("axial_to_lateral_gan_apollo", "axial_to_lateral_gan_athena",
          "axial_to_lateral_gan_dryops")


def find_model_using_name(model_name: str):
    if model_name not in PORTED:
        raise NotImplementedError(f"--model {model_name} is not ported yet (ROADMAP.md, "
                                  f"queue 1); the port has {PORTED}")
    from .base_model import BaseModel

    module_name = f"{__name__}.{model_name}_model"
    modellib = importlib.import_module(module_name)
    target = model_name.replace("_", "") + "model"
    for name, cls in modellib.__dict__.items():
        if (name.lower() == target.lower() and isinstance(cls, type)
                and issubclass(cls, BaseModel)):
            return cls
    raise NotImplementedError(f"In {module_name}.py, there should be a subclass of BaseModel "
                              f"with class name that matches {target} in lowercase.")


def get_option_setter(model_name: str):
    """The model's ``modify_commandline_options(parser, is_train=True)``."""
    return find_model_using_name(model_name).modify_commandline_options


def create_model(opt, device=None, plain: bool = False):
    """The model of ``opt.model`` on ``device`` (``plain``: on the kernels'
    plain versions)."""
    instance = find_model_using_name(opt.model)(opt, device, plain=plain)
    print(f"model [{type(instance).__name__}] was created", flush=True)
    return instance
