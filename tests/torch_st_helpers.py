"""Helpers shared by the port's segment-tree tests."""

import pytest

from gpu_stereo_matching_tpu.tree import hpd as jhpd
from gpu_stereo_matching_tpu_torch.tree import hpd as thpd


@pytest.fixture
def fresh_registries(tmp_path, monkeypatch):
    """Both packages' layout registries on empty files of their own, with
    empty dicts, so that their layouts start equal."""
    for mod in (jhpd, thpd):
        for name in ("_LAYOUT_REGISTRY", "_K_REGISTRY", "_ROUNDS_REGISTRY", "_SCAN_REGISTRY",
                     "_REAL_ROUNDS_REGISTRY", "_BUCKET_REGISTRY"):
            monkeypatch.setattr(mod, name, {})
    for mod, name in ((jhpd, "jax.json"), (thpd, "torch.json")):
        monkeypatch.setattr(mod, "_REGISTRY_PATH", str(tmp_path / name))
        monkeypatch.setattr(mod, "_REGISTRY_LOADED", False)
    return tmp_path
