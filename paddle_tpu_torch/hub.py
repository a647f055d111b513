"""paddle.hub — local-source model hub (port of ``paddle_tpu/hub.py``).

Parity: reference ``python/paddle/hapi/hub.py`` (list/help/load from github/
local sources). This environment has no network egress, so only the
``source='local'`` path is functional; remote sources raise with guidance.
"""
from __future__ import annotations

import importlib.util
import os
import sys

_HUB_CONF = "hubconf.py"


def _load_local(repo_dir):
    path = os.path.join(repo_dir, _HUB_CONF)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {_HUB_CONF} in {repo_dir}")
    spec = importlib.util.spec_from_file_location("hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["hubconf"] = mod
    spec.loader.exec_module(mod)
    return mod


def _check_source(source):
    if source != "local":
        raise NotImplementedError(
            "paddle.hub: only source='local' is available in this build "
            "(no network egress); point repo_dir at a local checkout with a "
            "hubconf.py"
        )


def list(repo_dir, source="local", force_reload=False):
    _check_source(source)
    mod = _load_local(repo_dir)
    return [n for n in dir(mod) if callable(getattr(mod, n)) and not n.startswith("_")]


def help(repo_dir, model, source="local", force_reload=False):
    _check_source(source)
    return getattr(_load_local(repo_dir), model).__doc__


def load(repo_dir, model, source="local", force_reload=False, **kwargs):
    _check_source(source)
    return getattr(_load_local(repo_dir), model)(**kwargs)


__all__ = ["list", "help", "load"]
