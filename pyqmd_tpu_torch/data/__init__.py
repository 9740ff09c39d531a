"""Nuclear data: half-life DB, decay chains, predictor, estimator, and their
dense (Z, N)-indexed tensor form (:mod:`pyqmd_tpu_torch.data.tables`)."""
