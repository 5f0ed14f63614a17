"""The trainer's step clock: step_time_s is read once the step's work has
finished on the card. gtax read its clock before the step's values were on
the host (gtax/train/trainer.py:522); the port's _materialize synchronizes
the card first. A stand-in device of type `cuda` and recorded calls pin
that order without a card.
"""

import types

import torch

from gtax_torch.train import trainer as trainer_mod


def test_materialize_synchronizes_before_the_clock(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(("sync", device)))

    def perf_counter():
        calls.append(("clock",))
        return 10.0

    monkeypatch.setattr(trainer_mod, "time",
                        types.SimpleNamespace(perf_counter=perf_counter))
    dev = types.SimpleNamespace(type="cuda")
    fake = types.SimpleNamespace(device=dev, mfu=None)
    out = trainer_mod.Trainer._materialize(
        fake, ({"loss": torch.tensor(0.5)}, 10.0, 1e-4))
    assert calls == [("sync", dev), ("clock",)]
    assert out == {"loss": 0.5, "step_time_s": 0.0, "learning_rate": 1e-4}


def test_materialize_reads_no_card_on_the_cpu(monkeypatch):
    """On the CPU there is nothing to wait for: no synchronize call."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append("sync"))
    monkeypatch.setattr(trainer_mod, "time",
                        types.SimpleNamespace(perf_counter=lambda: 3.0))
    fake = types.SimpleNamespace(device=torch.device("cpu"), mfu=None)
    out = trainer_mod.Trainer._materialize(fake, ({"loss": 1.0}, 1.0, 0.1))
    assert calls == [] and out["step_time_s"] == 2.0
