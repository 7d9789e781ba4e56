"""Flow sources of the port: the host-side iterator (``base.FlowSource``)
and the estimator configuration (``cv.CvFlowConfig``). The decoding
sources wait for the codec path."""
