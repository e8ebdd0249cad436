"""Video fixtures: the seeded frame sequences, the port's cv2-blocked run
and the digests of the MP4 files it writes, which ``tests/test_torch_video.py``
and ``chip_smoke.py`` phase ``image_io`` hold the port's encoder to."""
