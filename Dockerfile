# nimble_tpu container image (analog of the reference's jemalloc-preloaded
# image; reference: Dockerfile). The aligner is built in — no binary
# download step.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make zlib1g-dev libjemalloc2 \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/nimble_tpu
COPY pyproject.toml README.md ./
COPY nimble_tpu ./nimble_tpu
COPY native ./native

RUN pip install --no-cache-dir . "jax[cuda12]" matplotlib jinja2 \
    && make -C native

ENV LD_PRELOAD=/usr/lib/x86_64-linux-gnu/libjemalloc.so.2

ENTRYPOINT ["python3", "-m", "nimble_tpu"]
