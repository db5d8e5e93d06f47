"""``python -m repro_torch.train --arch resnet20 --backend quantized --steps N --width 1.0
--hw 32 --batch 128 --fmt 2,4``"""
from repro_torch.train.loop import main

if __name__ == "__main__":
    main()
