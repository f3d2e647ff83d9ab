"""The port's counterparts of the repository's root `tracking/*.py` command
lines, one module per script under the script's own name and with its
flags: `python -m multi_modal_tracking_torch.tools.<name>`.

  profile_model          parameters, matmul+conv FLOPs, device ms a frame
  fps                    frames / seconds over <seq>_time.txt files
  analysis_results       metric tables (and plots) of result directories
  analysis_results_vtuav the VTUAV splits of analysis_results
  analysis_results_ITP   tables over a results root and tracker names
  analysis_results_crossdatasets  AUC / precision over several datasets
  analysis_results_plot  success / precision plots beside external results
  create_default_local_file, pre_read_datasets   workspace and data helpers
  vis_attn, search_vis   attention maps and search features as PNG panels
  gen_video, gen_video_uavtir, video_demo, imgs2video, video2imgs   videos

The tools that track or profile run on the GPU unless given `--device cpu`.
Plots need matplotlib and video containers (mp4 in or out) cv2; without
them those tools raise ImportError. Importing a tool imports neither.
The existing entry points keep their places: `eval.run` (test.py),
`train.run`, `train.refine`, `eval.vot` and `classic.run`.
"""
