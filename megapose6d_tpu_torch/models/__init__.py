"""Networks: the ResNet backbone and the coarse/refiner PosePredictor."""
