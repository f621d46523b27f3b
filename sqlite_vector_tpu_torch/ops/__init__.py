"""Device ops of the PyTorch port: plain torch ops plus the hand-written
block-minima kernel (block_scan). Module names mirror
sqlite_vector_tpu/ops/."""
