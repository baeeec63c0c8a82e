"""The model hub — the port of ``paddle_tpu/hapi/hub.py``: ``list``,
``help`` and ``load`` of the entry points a ``hubconf.py`` directory
exports. The 'local' source is supported; 'github' and 'gitee' fetch an
archive over the network, which the port does not do: they raise with
the reference's message unless the archive is already in the cache
directory (the repo-spec parsing and cache layout are the reference's).
"""
from __future__ import annotations

import os
import sys

__all__ = []

MODULE_HUBCONF = "hubconf.py"
VAR_DEPENDENCY = "dependencies"
HUB_DIR = os.path.expanduser(os.path.join("~", ".cache", "paddle_tpu",
                                          "hub"))


def _import_module(name, repo_dir):
    """reference: hapi/hub.py:38 — import hubconf.py from repo_dir."""
    import importlib.util

    path = os.path.join(repo_dir, MODULE_HUBCONF)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {MODULE_HUBCONF} in {repo_dir}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    finally:
        sys.modules.pop(name, None)
    return module


def _parse_repo_info(repo, source):
    """reference: hapi/hub.py:63 — 'owner/name[:branch]' → parts."""
    if ":" in repo:
        repo_info, branch = repo.split(":")
    else:
        repo_info, branch = repo, "main" if source == "github" else "master"
    owner, repo_name = repo_info.split("/")
    return owner, repo_name, branch


def _get_cache_or_reload(repo, force_reload, verbose=True, source="github"):
    """reference: hapi/hub.py:81 — network archive fetch; gated here."""
    owner, repo_name, branch = _parse_repo_info(repo, source)
    cached = os.path.join(
        HUB_DIR, "_".join([owner, repo_name, branch.replace("/", "_")])
    )
    if os.path.exists(cached) and not force_reload:
        return cached
    raise RuntimeError(
        f"source='{source}' requires network access, which this environment "
        f"does not have; pre-populate {cached} or use source='local' with a "
        "directory containing hubconf.py"
    )


def _check_module_exists(name):
    import importlib.util

    return importlib.util.find_spec(name) is not None


def _check_dependencies(m):
    """reference: hapi/hub.py:158 — verify hubconf's `dependencies` list."""
    dependencies = getattr(m, VAR_DEPENDENCY, None)
    if dependencies is not None:
        missing = [pkg for pkg in dependencies if not _check_module_exists(pkg)]
        if missing:
            raise RuntimeError(
                f"Missing dependencies: {missing}"
            )


def _load_entry_from_hubconf(m, name):
    """reference: hapi/hub.py:135."""
    if not isinstance(name, str):
        raise ValueError("Invalid input: model should be a str of function name")
    func = getattr(m, name, None)
    if func is None or not callable(func):
        raise RuntimeError(f"Cannot find callable {name} in hubconf")
    return func


def _repo_dir(repo_dir, source, force_reload):
    if source not in ("github", "gitee", "local"):
        raise ValueError(
            f'Unknown source: "{source}". Allowed values: "github" | "gitee" | "local".'
        )
    if source in ("github", "gitee"):
        return _get_cache_or_reload(repo_dir, force_reload, True, source)
    return repo_dir


def list(repo_dir, source="github", force_reload=False):
    """List callable entrypoints exported by the repo's hubconf.py
    (reference: hapi/hub.py:170)."""
    repo_dir = _repo_dir(repo_dir, source, force_reload)
    hub_module = _import_module(MODULE_HUBCONF.split(".")[0], repo_dir)
    return [
        f
        for f in dir(hub_module)
        if callable(getattr(hub_module, f)) and not f.startswith("_")
    ]


def help(repo_dir, model, source="github", force_reload=False):
    """Docstring of one hub entrypoint (reference: hapi/hub.py:214)."""
    repo_dir = _repo_dir(repo_dir, source, force_reload)
    hub_module = _import_module(MODULE_HUBCONF.split(".")[0], repo_dir)
    return _load_entry_from_hubconf(hub_module, model).__doc__


def load(repo_dir, model, source="github", force_reload=False, **kwargs):
    """Instantiate a hub entrypoint (reference: hapi/hub.py:256)."""
    repo_dir = _repo_dir(repo_dir, source, force_reload)
    hub_module = _import_module(MODULE_HUBCONF.split(".")[0], repo_dir)
    _check_dependencies(hub_module)
    return _load_entry_from_hubconf(hub_module, model)(**kwargs)
