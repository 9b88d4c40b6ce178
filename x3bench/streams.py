"""Each client's streams, made from the run's seed and the client's index.

A configuration file says how long the streams are (`streams`) and what
they sound like (`signal`).  The lengths are the same for every seed, so
every seed gives the same work; the seed draws the order of the streams
and their samples.  The samples are made on the run's device by one
torch.Generator in a few large calls and read back once.

The hydrophone class is a frozen copy of x3_tpu_torch.bench's
`make_corpus` rule (a slow 2,000-count sine of period 9,773 samples under
normal noise of 6 counts, rounded and clipped to int16), each stream
starting at phase 0; it compresses about 2.9x."""

from __future__ import annotations

import numpy as np

SLOW_AMPLITUDE = 2000.0
SLOW_PERIOD = 9773
NOISE_SIGMA = 6.0


def client_seed(seed: int, client: int, purpose: int = 0) -> int:
    """A 63-bit seed for one client's draws, from the run's seed (any whole
    number, negative or past 64 bits included) and the client's index."""
    words = [abs(int(seed)) >> (32 * i) & 0xFFFFFFFF for i in range(3)] + [int(seed < 0), client, purpose]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def stream_lengths(spec: dict, seed: int, client: int) -> list[int]:
    """The lengths of a client's streams in the order it converts them.

    spec: {"lengths": [...]} lists them; {"uniform": {"count", "low",
    "high"}} adds `count` lengths spread evenly over low..high (the
    midpoints of `count` equal parts: uniform, and the same for every
    seed); "shuffle": true puts them in an order drawn from the seed."""
    lengths = [int(n) for n in spec.get("lengths", [])]
    uni = spec.get("uniform")
    if uni:
        lo, hi, k = uni["low"], uni["high"], uni["count"]
        lengths += [int(lo + (hi - lo) * (i + 0.5) / k + 0.5) for i in range(k)]
    if spec.get("shuffle"):
        order = np.random.default_rng(client_seed(seed, client, 1)).permutation(len(lengths))
        lengths = [lengths[i] for i in order]
    return lengths


def hydrophone(lengths: list[int], seed: int, device) -> list[np.ndarray]:
    import torch

    total = sum(lengths)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    noise = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    starts = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    # Each stream's own sample index, so every stream starts at phase 0.
    t = torch.arange(total, device=device, dtype=torch.int64)
    first = torch.repeat_interleave(torch.as_tensor(starts[:-1], device=device),
                                    torch.as_tensor(lengths, device=device), output_size=total)
    phase = ((t - first) % SLOW_PERIOD).to(torch.float64) * (2 * np.pi / SLOW_PERIOD)
    x = SLOW_AMPLITUDE * torch.sin(phase) + NOISE_SIGMA * noise.to(torch.float64)
    flat = torch.clamp(torch.round(x), -32768, 32767).to(torch.int16).cpu().numpy()
    return [flat[a:b] for a, b in zip(starts[:-1], starts[1:])]


SIGNALS = {"hydrophone": hydrophone}


def make_streams(config: dict, seed: int, client: int, device) -> list[np.ndarray]:
    """The int16 streams client `client` converts, as host arrays."""
    lengths = stream_lengths(config["streams"], seed, client)
    return SIGNALS[config["signal"]](lengths, client_seed(seed, client), device)
