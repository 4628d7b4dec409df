"""The accelerator a measurement runs on, and what it is.

Speed and on-card numerics are only meaningful on the GPU, so the
measuring entry points (bench.py, chip_smoke.py) refuse to run anywhere
else instead of falling back to the CPU, and every result they print
names the device: JAX's platform, device kind and count, and the card's
name and power limit as nvidia-smi reports them (a card set below its
maximum power runs slower under load).
"""

import subprocess

import jax


def nvidia_smi():
    """`name, power.limit` of each card, one line each, or a note."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return "nvidia-smi unavailable (%s)" % type(e).__name__


def require_gpu():
    """Device description dict; RuntimeError when JAX has no GPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError("no GPU: JAX's devices are %s" % devs)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": nvidia_smi()}
