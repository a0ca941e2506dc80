"""Traffic flow: (steps, N, F) vehicles per 5 minutes at PEMS08's shape. A
two-peak daily profile, a weekend dip, a capacity per sensor, and noise
that is smooth in time; every feature is a scaled copy of the flow."""
import numpy as np


def make(rng: np.random.Generator, *, steps: int, nodes: int, features: int,
         steps_per_day: int = 288) -> np.ndarray:
    t = np.arange(steps, dtype=np.float64)
    day = (t % steps_per_day) / steps_per_day
    weekday = ((t // steps_per_day) % 7) < 5
    profile = (0.25 + 0.75 * np.exp(-((day - 0.33) / 0.06) ** 2)
               + 0.65 * np.exp(-((day - 0.73) / 0.08) ** 2)
               + 0.35 * np.sin(np.pi * day) ** 2)
    profile = profile * np.where(weekday, 1.0, 0.7)
    capacity = rng.uniform(150.0, 450.0, size=nodes)
    phase = rng.integers(-6, 7, size=nodes)
    base = profile[(np.arange(steps)[:, None] - phase[None, :]) % steps] * capacity[None, :]
    noise = rng.normal(size=(steps, nodes))
    noise = (noise + np.roll(noise, 1, 0) + np.roll(noise, 2, 0)) / 3.0
    sig = np.maximum(base * (1.0 + 0.08 * noise), 0.0).astype(np.float32)
    return np.stack([sig * (1.0 + 0.1 * f) for f in range(features)], axis=-1)
