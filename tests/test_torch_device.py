"""The port's model and cache entry points run on the card unless the
caller names a device: with no device and no CUDA they raise an error
that names ``device='cpu'``; with ``device="cpu"`` they build on the CPU.

CUDA is hidden with ``monkeypatch`` so the refusals are tested the same
way on a machine with a card.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import device as tdevice  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api, encdec, lm  # noqa: E402


def _gen():
    return torch.Generator().manual_seed(0)


#: (name, family config, call with the device keyword added)
ENTRY_POINTS = [
    ("api.init_cache_fn gemma", "gemma-2b",
     lambda cfg, **kw: api.init_cache_fn(cfg, 2, 8, torch.float32, **kw)),
    ("api.init_cache_fn whisper", "whisper-base",
     lambda cfg, **kw: api.init_cache_fn(cfg, 2, 8, torch.float32, **kw)),
    ("api.init_paged_cache_fn", "gemma-2b",
     lambda cfg, **kw: api.init_paged_cache_fn(cfg, 2, 5, 4, 2, **kw)),
    ("lm.init", "gemma-2b", lambda cfg, **kw: lm.init(_gen(), cfg, **kw)),
    ("lm.init_cache", "gemma-2b",
     lambda cfg, **kw: lm.init_cache(cfg, 2, 8, **kw)),
    ("lm.init_paged_cache", "gemma-2b",
     lambda cfg, **kw: lm.init_paged_cache(cfg, 2, 5, 4, 2, **kw)),
    ("encdec.init", "whisper-base",
     lambda cfg, **kw: encdec.init(_gen(), cfg, **kw)),
    ("encdec.init_cache", "whisper-base",
     lambda cfg, **kw: encdec.init_cache(cfg, 2, 8, **kw)),
]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("entry", ENTRY_POINTS, ids=lambda e: e[0])
def test_no_device_without_cuda_names_the_cpu(entry, monkeypatch):
    _, arch, call = entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(get_config(arch).smoke())


@pytest.mark.parametrize("entry", ENTRY_POINTS, ids=lambda e: e[0])
def test_cpu_device_builds_on_the_cpu(entry, monkeypatch):
    _, arch, call = entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    leaves = list(_leaves(call(get_config(arch).smoke(), device="cpu")))
    assert leaves and all(t.device.type == "cpu" for t in leaves)


def test_cuda_asked_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        lm.init_cache(get_config("gemma-2b").smoke(), 2, 8, device="cuda")


def test_serve_reexports_the_one_resolver():
    assert serve.resolve_device is tdevice.resolve_device


def test_refusals_come_before_the_device():
    """The encdec refusals (int8 KV, a paged cache) name what they refuse
    whatever the device."""
    cfg = get_config("whisper-base").smoke()
    with pytest.raises(NotImplementedError, match="int8"):
        encdec.init_cache(cfg, 2, 16, torch.int8)
    with pytest.raises(NotImplementedError, match="paged"):
        api.init_paged_cache_fn(cfg, 2, 8, 4, 4)
