"""The offline evaluation suite of the port (the counterpart of ``experiments/``).

Scores served zarr stores against the truth on the ×255 scale: exp1 (MAE,
RMSE, PSS, SSIM, DTSSIM, NSE, POD/FAR/CSI/HSS at 0.5/2/4/8 mm/h), exp2 (GIFs
and the paper figure), exp3 (NSE per event and its figures), and the data
inspection report. Scores run on tensors of an explicit device, ``cuda``
unless the caller passes ``cpu``; figures are drawn on the host.

    python -m p2igan_tpu_torch.experiments.main --config exp.json [--device cpu]
"""
