"""Public runtime-env type.

Analog of the reference's ``ray.runtime_env.RuntimeEnv``
(python/ray/runtime_env/runtime_env.py): a validated dict describing the
environment tasks/actors run in. Supported fields: ``env_vars`` (dict),
``working_dir`` (local path), ``py_modules`` (list of local paths).
``pip``/``conda``/``container`` are recognized but rejected — provisioning
them needs package installation, which this deployment model does not do;
bake dependencies into the node image instead.
"""

from __future__ import annotations

KNOWN_FIELDS = {"env_vars", "working_dir", "py_modules", "pip", "conda", "container"}
# Provisioning these needs package installation (network); rejected at
# submission (core_worker) and defensively at worker startup (worker_main).
UNSUPPORTED_FIELDS = {"pip", "conda", "container"}


class RuntimeEnv(dict):
    def __init__(
        self,
        *,
        env_vars: dict | None = None,
        working_dir: str | None = None,
        py_modules: list | None = None,
        **kwargs,
    ):
        super().__init__()
        unknown = set(kwargs) - KNOWN_FIELDS
        if unknown:
            raise ValueError(f"unknown runtime_env fields: {sorted(unknown)}")
        if env_vars is not None:
            if not isinstance(env_vars, dict) or not all(
                isinstance(k, str) and isinstance(v, str) for k, v in env_vars.items()
            ):
                raise TypeError("env_vars must be a dict[str, str]")
            self["env_vars"] = dict(env_vars)
        if working_dir is not None:
            if not isinstance(working_dir, str):
                raise TypeError("working_dir must be a local path string")
            self["working_dir"] = working_dir
        if py_modules is not None:
            if not isinstance(py_modules, (list, tuple)):
                raise TypeError("py_modules must be a list of local path strings")
            self["py_modules"] = [str(p) for p in py_modules]
        for key in ("pip", "conda", "container"):
            if key in kwargs:
                self[key] = kwargs[key]
