"""Where the program runs: the accelerator decision, device memory, the
compile cache, and which card a process takes.

Every choice that differs between the CPU and an accelerator (GPU) is made
here, from JAX's default backend, so the engines ask one question instead
of testing platform names themselves.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# share of a device's memory a single-hash table may take (the rest holds
# the other tables, the read spans and the step's transients)
TABLE_SHARE = 3 / 8


def backend() -> str:
    """JAX's default backend name ("cpu", "gpu", ...)."""
    return jax.default_backend()


def on_accelerator() -> bool:
    """True off the CPU. The accelerator configuration (scanned dispatch,
    emission cap, compact wire, large chunks) is taken exactly when this
    holds; the CPU keeps the small single-chunk configuration the tests
    compare against."""
    return backend() != "cpu"


def device_bytes_limit(device=None) -> int:
    """Memory the JAX allocator may use on `device` (default: the first
    device). A device that reports no limit is an error: sizes are never
    assumed."""
    device = device if device is not None else jax.devices()[0]
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError(
            f"{device.platform} device {device.device_kind!r} reports no "
            "bytes_limit; pass a memory size explicitly"
        )
    return int(stats["bytes_limit"])


def host_bytes() -> int:
    """Physical memory of the host: the CPU backend's device memory."""
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def table_bytes_cap(bytes_limit: int) -> int:
    """Largest single-hash table (mono / group layouts) for a device with
    `bytes_limit` bytes of memory."""
    return int(bytes_limit * TABLE_SHARE)


def memory_bytes() -> int:
    """Memory of the device the engines run on: its own allocator limit,
    or the host's memory for a CPU device."""
    device = jax.devices()[0]
    return host_bytes() if device.platform == "cpu" else device_bytes_limit(device)


def compile_cache_dir() -> Optional[str]:
    """Persist compiled executables across CLI runs. JAX_COMPILATION_CACHE_DIR,
    when set, is JAX's own setting and the only cache used (returns None);
    otherwise the cache lives at the fixed path <repo>/.jax_cache."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    cache_dir = os.path.join(REPO_ROOT, ".jax_cache")
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir


def device_line() -> str:
    devs = jax.devices()
    return (
        f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}"
    )


def print_device_line() -> None:
    """One stderr line naming the devices a run uses, so a run that fell
    back to the CPU is never mistaken for one on the card."""
    print(device_line(), file=sys.stderr, flush=True)


def card_for_process(proc_id: int, num_procs: int, n_cards: int) -> Optional[str]:
    """The card (as a visible-devices string) that process `proc_id` of
    `num_procs` takes on a host with `n_cards` cards; None on a host with
    none. More processes than cards is an error: two JAX processes on one
    card each reserve most of its memory and the second fails."""
    if n_cards <= 0:
        return None
    if num_procs > n_cards:
        raise ValueError(
            f"{num_procs} processes for {n_cards} card(s): one process per card"
        )
    return str(proc_id)


def cuda_card_count() -> int:
    """Cards the CUDA driver sees (honouring CUDA_VISIBLE_DEVICES), asked
    through libcuda without starting a JAX backend; 0 on a host without
    the driver or when JAX is held to the CPU."""
    platforms = os.environ.get("JAX_PLATFORMS", "") or (
        jax.config.jax_platforms or ""
    )
    if platforms and "cuda" not in platforms and "gpu" not in platforms:
        return 0
    import ctypes

    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return 0
    count = ctypes.c_int(0)
    if cuda.cuInit(0) != 0 or cuda.cuDeviceGetCount(ctypes.byref(count)) != 0:
        return 0
    return count.value


def claim_card(proc_id: int, num_procs: int) -> None:
    """Give this process card `proc_id` alone. Must run before JAX starts
    its backends."""
    card = card_for_process(proc_id, num_procs, cuda_card_count())
    if card is not None:
        jax.config.update("jax_cuda_visible_devices", card)
