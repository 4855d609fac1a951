"""Frozen plain-PyTorch references of what the benchmark's cells run: the
four truncated ENS surrogates (:mod:`.surrogates`), the ENS-I2V Adam steps
(:mod:`.i2v`) and the six Kinetics-400 video classifiers (:mod:`.video`).

They import nothing of ``i2v_tpu_torch`` and take nothing it made: the
benchmark makes the weights and the inputs (:mod:`port_bench.weights`,
:mod:`port_bench.traffic`) and hands the same to both sides. Parameter names
follow the port's modules, so one state dict fills either side."""
