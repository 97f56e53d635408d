"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W power limit). A roofline share is stated against these."""

PEAK_OPS_F32 = 67e12       # f32 operations/s outside the tensor cores
HBM_BW = 3.35e12           # HBM bytes/s
