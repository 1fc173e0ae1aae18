"""The application's namespace: counterpart of
`alphatriangle_tpu/config/app_config.py`. The port's own name, so its
runs live beside the JAX package's, never in them
(`<ROOT_DATA_DIR>/<APP_NAME>/runs/`)."""

APP_NAME = "AlphaTriangleTPUTorch"
