from octseg_torch.explain.cam import CAM_METHODS, CAMProcessor, SemanticSegmentationTarget

__all__ = ['CAMProcessor', 'CAM_METHODS', 'SemanticSegmentationTarget']
