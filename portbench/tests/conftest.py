"""Fixtures of the benchmark's CPU tests: the tiny arch registered with
the program, the data cache in a temporary directory, and medoids pinned
on both sides where a test needs the rest of the arithmetic alone."""
import pytest
import torch

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
    """The first K tokens of every segment as its medoids, in the program
    and in the reference: a flip of a near tie between two medoids, which
    the bf16 and fp32 streams can make, cannot then hide the rest."""
    import centerclip_tpu_torch.ops.cluster_layer as cluster_layer
    import portbench.reference.model as ref

    def port(X, K, **kw):
        B, N = X.shape[:2]
        ids = torch.arange(K, dtype=torch.int32, device=X.device)
        return (torch.zeros((B, N), dtype=torch.int32, device=X.device),
                ids.expand(B, K).contiguous())

    monkeypatch.setattr(cluster_layer, "kmedoids", port)
    monkeypatch.setattr(ref, "kmedoids", lambda X, K, iter_limit=100:
                        torch.arange(K, device=X.device).expand(X.shape[0],
                                                                K))
