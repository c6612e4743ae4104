"""nimble_tpu — an accelerator pseudoalignment and gene-quantification engine.

Re-implements the full capability surface of BimberLab/nimble as a new
device-first design: the k-mer reference index lives in device memory as
hash-table + equivalence-class bitset tensors, read batches stream
data-parallel into a JAX match-and-score step, and cell-barcode/UMI
quantification runs as exact host reductions (with a device segment-op path
for scale).

Public modules:
  nimble_tpu.config     — library Config/Data schema ([Config, Data] JSON)
  nimble_tpu.library    — library generation (FASTA/CSV -> library JSON)
  nimble_tpu.index      — k-mer index builder -> device tensors
  nimble_tpu.align      — alignment engine (XLA)
  nimble_tpu.quant      — per-UMI thresholding / intersection / counting
  nimble_tpu.barcode    — 10x FASTQ -> tagged BAM conversion
  nimble_tpu.io         — FASTA/FASTQ/BAM readers and writers
  nimble_tpu.parallel   — device mesh setup and sharding planners
  nimble_tpu.accel      — CPU vs accelerator decision, device memory, cache
  nimble_tpu.report     — TSV emission and HTML QC reports
"""

__version__ = "0.1.0"
