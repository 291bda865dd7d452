from .detect import DetectConfig, DetectResult, detect_run, WindowPredictor
