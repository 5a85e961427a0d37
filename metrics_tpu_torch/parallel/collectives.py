"""Constants of the q8_block quantized codec (port of the constants in
``metrics_tpu/parallel/collectives.py``). The collectives themselves are not
ported yet; the engine's at-rest codec (``engine/quantize.py``) and the
metric's ``sync_precision`` policy read these."""

#: elements per absmax-scale block of the block-scaled int8 codec
Q8_BLOCK = 32

#: the declared sync precisions; "exact" is the default everywhere
SYNC_PRECISIONS = ("exact", "q8_block")

#: blocks whose absmax sits below this flush to zero codes: the scale
#: absmax/127 would be subnormal there, and 1/scale overflows f32
Q8_FLUSH = 1.5e-36
