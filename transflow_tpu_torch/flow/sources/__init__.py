"""Flow sources of the port: the host-side iterator (``base.FlowSource``,
with ``from_args``), the estimator configuration and image-sequence
source (``cv``), and the ``.flow.zip`` replay (``archive``)."""
