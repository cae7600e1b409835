"""Traffic: the mixes' parameter files (``<name>.json``) and the one
generator of the inputs they describe (``synthetic.py``)."""
