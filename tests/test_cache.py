"""The persistent-compilation-cache rule (utils/cache.py): the variable
JAX_COMPILATION_CACHE_DIR wins and nothing else is set; otherwise one fixed,
gitignored directory inside the checkout; never on the CPU."""

import os

from madipm_tpu.utils.cache import DEFAULT_CACHE_DIR, configure_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeJax:
    """Records config updates instead of touching the process's jax."""

    def __init__(self):
        self.config = self
        self.updates = []

    def update(self, key, value):
        self.updates.append((key, value))


def test_env_dir_is_used_and_nothing_else(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    fake = _FakeJax()
    assert configure_cache(fake, "gpu") == str(tmp_path)
    assert fake.updates == [("jax_compilation_cache_dir", str(tmp_path))]


def test_default_is_fixed_gitignored_dir_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first, second = _FakeJax(), _FakeJax()
    path = configure_cache(first, "gpu")
    assert path == configure_cache(second, "gpu") == DEFAULT_CACHE_DIR
    assert first.updates == second.updates == [("jax_compilation_cache_dir", path)]
    assert os.path.dirname(path) == REPO
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert os.path.basename(path) + "/" in f.read().split()


def test_cpu_cache_stays_disabled(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    fake = _FakeJax()
    assert configure_cache(fake, "cpu") == ""
    assert fake.updates == [("jax_compilation_cache_dir", None)]
