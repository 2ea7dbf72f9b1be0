"""Fixtures of the benchmark's CPU tests: the tiny arch registered with
the program, the data cache in a temporary directory, and medoids pinned
on both sides where a test needs the rest of the arithmetic alone."""
import pytest

from portbench.tests import tiny


@pytest.fixture(scope="session")
def cache_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench_cache"))


@pytest.fixture
def tiny_env(monkeypatch, cache_dir):
    tiny.register()
    import portbench.kinds as kinds
    monkeypatch.setattr(kinds, "CACHE", cache_dir)
    return cache_dir


@pytest.fixture
def pinned_medoids(monkeypatch):
    """`tiny.pin_medoids`: where a test needs the rest of the arithmetic
    alone."""
    tiny.pin_medoids(monkeypatch.setattr)
