"""The port's measuring and sweep programs, each run as
``python -m wildgs_slam_tpu_torch.scripts.<name>`` (the ``run_*_all.sh``
sweeps from the repository root):

- ``profile_rasterizer``: torch.profiler over the bench step;
- ``profile_mapping_raster``: the same at mapping scale;
- ``profile_map_opt``: the mapper's optimisation segment;
- ``profile_global_ba``: ``Backend.dense_ba`` on a synthetic store;
- ``profile_pipeline``: ``SLAM.run()`` on a synthetic TUM scene;
- ``summarize_pose_eval``: the per-scene ATE of a sweep as a CSV;
- ``ab_bin_kw``: the binning window (``bin_kw``) A/B on a densified map;
- ``ab_update_eps``: the frontend's early exit (``update_eps``) A/B under
  the oracle;
- ``microbench_motion_filter``: ``MotionFilter.track`` per frame;
- ``microbench_frontend``: one warm ``FactorGraph.update``.

Each runs on the card, and stops without one unless ``--device cpu`` is
given.
"""
