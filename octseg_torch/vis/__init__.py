"""The figures of a cross-validation study (the port of octseg/vis/):
``draw_loss_plot`` (training curves with bootstrap confidence bands) and
``draw_boxplots`` (best-epoch metrics per class), written as SVG."""
