"""Drawing fixtures: the committed font's extraction script and the
detections, annotations and digests that ``tests/test_torch_vis_draw.py``
and ``chip_smoke.py`` phase ``image_io`` draw with ``tools/vis_results.py``."""
