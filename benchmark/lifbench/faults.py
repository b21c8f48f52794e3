"""Faults planted around a cell's entry call (harness.run's `wrap`), each
of which the output check has to find: the tests run them at a tiny size
on the CPU, control.py at a cell's own size on the card."""

import torch

from .traffic import count


def stale(call):
    """A call that returns the previous call's frames unchanged."""
    last = []

    def wrapped(poses):
        out = call(poses)
        if last:
            out, last[0] = last[0], out
        else:
            last.append(out)
        return out
    return wrapped


def half(call):
    """Half of each batch left out: the other half gets their mean."""
    def wrapped(poses):
        n = count(poses)
        out = call({k: v[: n - n // 2] for k, v in poses.items()})
        return torch.cat([out, out.mean(0, keepdim=True).expand(
            n // 2, *out.shape[1:])])
    return wrapped


def altered(call):
    """Each frame's centre pixel altered where it is produced."""
    def wrapped(poses):
        out = call(poses).clone()
        h, w = out.shape[1:3]
        out[:, h // 2, w // 2, 0] += 0.25
        return out
    return wrapped


def one_slot(call):
    """The centre pixel altered in the frames of one run of max(1, n // 9)
    cameras of each call, the last: one pose chunk of a 432-pose call,
    the fourth camera of a four-camera rig."""
    def wrapped(poses):
        out = call(poses).clone()
        n = out.shape[0]
        h, w = out.shape[1:3]
        out[n - max(1, n // 9):, h // 2, w // 2, 0] += 0.25
        return out
    return wrapped


FAULTS = {f.__name__: f for f in (stale, half, altered, one_slot)}
