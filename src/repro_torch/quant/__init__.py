"""SmoothQuant calibration and W8A8 weight preparation
(``quant.apply.quantize_params``)."""
