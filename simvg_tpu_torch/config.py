"""Python-file configuration with ``_base_`` inheritance (port of
``simvg_tpu/config/config.py``).

The port reads the unchanged files under ``configs/``: a config file is
executable Python whose module-level, non-underscore variables become the
config dict, and ``_base_ = [relative paths]`` merges the parents first
(the child overrides recursively; ``_delete_=True`` replaces a parent
dict).  ``merge_from_dict``, ``dump`` and ``parse_cfg_options`` give the
CLIs their ``--cfg-options`` surface.  It is a copy of the JAX package's
``simvg_tpu/config/config.py`` so that the port, and a run of it on a
machine without JAX, loads nothing of ``simvg_tpu``;
``tests/test_torch_model.py`` holds the two to the same result on every
file under ``configs/``.
"""

from __future__ import annotations

import copy
import os.path as osp
import types
from typing import Any, Dict, List


class Config(dict):
    """dict with attribute access (recursive)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config({k: Config._wrap(x) for k, x in v.items()})
        if isinstance(v, list):
            return [Config._wrap(x) for x in v]
        return v

    @staticmethod
    def _exec_file(path: str) -> Dict[str, Any]:
        with open(path) as f:
            code = f.read()
        module = types.ModuleType("_cfg")
        module.__dict__["__file__"] = path
        exec(compile(code, path, "exec"), module.__dict__)
        out = {
            k: v
            for k, v in module.__dict__.items()
            if not k.startswith("_")
            and not isinstance(v, (types.ModuleType, types.FunctionType,
                                   type))
        }
        if "_base_" in module.__dict__:
            out["_base_"] = module.__dict__["_base_"]
        return out

    @staticmethod
    def _merge(base: Dict, new: Dict) -> Dict:
        out = copy.deepcopy(base)
        for k, v in new.items():
            if isinstance(v, dict) and v.get("_delete_"):
                # mmcv-style replace marker: drop the parent value
                v = {kk: vv for kk, vv in v.items() if kk != "_delete_"}
                out[k] = copy.deepcopy(v)
            elif (k in out and isinstance(out[k], dict)
                    and isinstance(v, dict)):
                out[k] = Config._merge(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
        return out

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        path = osp.abspath(path)
        raw = cls._exec_file(path)
        bases: List[str] = raw.pop("_base_", [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for b in bases:
            merged = cls._merge(merged,
                                cls.fromfile(osp.join(osp.dirname(path), b)))
        return cls._wrap(cls._merge(merged, raw))

    def merge_from_dict(self, options: Dict[str, Any]):
        """Dotted-key overrides: {"model.head.num_queries": 10}."""
        for key, val in options.items():
            parts = key.split(".")
            node = self
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], dict):
                    node[p] = Config()
                node = node[p]
            node[parts[-1]] = Config._wrap(val)

    def dump(self, path: str):
        import pprint

        with open(path, "w") as f:
            f.write(pprint.pformat(dict(self), width=88))


def parse_cfg_options(pairs):
    """Parse CLI ``--cfg-options key=value`` pairs into a dotted-key
    dict for ``Config.merge_from_dict``.  Values are python literals
    where possible, else strings."""
    import ast

    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out
