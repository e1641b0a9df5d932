"""``kernels.launch``, the path every hand kernel's wrapper takes to its
C entry, on the CPU: a fake library stands in for the nvcc build
(``kernels.load`` patched) and fake ``torch.cuda`` calls for the card.
The entry is looked up once per (source, symbol); the current stream
goes last; the device is entered only when it is not the current one; a
non-zero error code raises."""
import contextlib

import pytest
import torch

from flex_tpu_torch import kernels


class FakeLib:
    def __init__(self, err=0):
        self.calls = []
        self.err = err

    def __getattr__(self, symbol):
        def entry(*args):
            self.calls.append((symbol, args))
            return self.err
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """(the fake library, the loads made, the devices entered) with card 0
    current and its stream 1234 (5678 on card 1)."""
    lib, loads, entered = FakeLib(), [], []
    current = [0]

    def load(name):
        loads.append(name)
        return lib

    @contextlib.contextmanager
    def device(index):
        entered.append(index)
        old, current[0] = current[0], index
        try:
            yield
        finally:
            current[0] = old

    class Stream:
        def __init__(self, index):
            i = current[0] if index is None else index
            self.cuda_stream = 1234 if i == 0 else 5678

    monkeypatch.setattr(kernels, "_fns", {})
    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "device", device)
    return lib, loads, entered


def test_launch_looks_up_each_entry_once(fake_card):
    lib, loads, _ = fake_card
    dev = torch.device("cuda", 0)
    for _ in range(3):
        kernels.launch("micro", "flex_smem_probe", dev, 11, 22, 4096)
    kernels.launch("micro", "flex_empty_probe", dev, 4096)
    kernels.launch("micro", "flex_smem_probe", dev, 11, 22, 8192)
    assert loads == ["micro", "micro"]
    assert [c[0] for c in lib.calls] == ["flex_smem_probe"] * 3 + [
        "flex_empty_probe", "flex_smem_probe"]


@pytest.mark.parametrize("dev", [torch.device("cuda", 0),
                                 torch.device("cuda")])
def test_launch_passes_the_current_stream_last(fake_card, dev):
    lib, _, entered = fake_card
    kernels.launch("micro", "flex_smem_probe", dev, 11, 22, 4096)
    assert lib.calls == [("flex_smem_probe", (11, 22, 4096, 1234))]
    assert entered == []   # the current device: no switch


def test_launch_enters_a_device_that_is_not_current(fake_card):
    lib, _, entered = fake_card
    kernels.launch("micro", "flex_smem_probe", torch.device("cuda", 1), 1, 2,
                   4096)
    assert entered == [1]
    assert lib.calls == [("flex_smem_probe", (1, 2, 4096, 5678))]
    assert torch.cuda.current_device() == 0


def test_launch_raises_the_entrys_error(fake_card, monkeypatch):
    monkeypatch.setattr(kernels, "load", lambda name: FakeLib(err=1))
    with pytest.raises(RuntimeError, match="flex_smem_probe launch failed: "
                                           "CUDA error 1"):
        kernels.launch("micro", "flex_smem_probe", torch.device("cuda", 0),
                       1, 2, 237568)
