"""Row-width scaling of XLA's row gather: is a 96-int32 row as cheap as 16?"""
import pathlib, sys, time
import numpy as np, jax, jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from nimble_tpu import accel

accel.compile_cache_dir()

N = 655360
CAP = 131072
idx = jnp.asarray(np.random.randint(0, CAP, size=(N,)), jnp.int32)

for width in (8, 16, 32, 64, 96, 128):
    tab = jnp.asarray(np.random.randint(0, 1000, size=(CAP, width)), jnp.int32)
    jf = jax.jit(lambda t, i: t[i].sum())
    t0 = time.time()
    _ = int(jf(tab, idx))
    comp = time.time() - t0
    best = 1e9
    for _r in range(4):
        t0 = time.time()
        acc = 0
        for _ in range(6):
            acc = acc + jf(tab, idx)
        _ = int(acc)
        best = min(best, (time.time() - t0) / 6)
    print(
        f"width {width:4d}: compile {comp:6.1f}s  {best*1e3:7.2f} ms  "
        f"{N/best/1e6:6.1f} M rows/s",
        flush=True,
    )
