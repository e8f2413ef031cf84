"""The control channel and the map's HTML export; the port's own copies of
``wildgs_slam_tpu/gui/control.py`` and the export half of
``wildgs_slam_tpu/gui/html_viewer.py``."""
