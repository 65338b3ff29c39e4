"""DICOM metadata extractor: data/dcm -> data/dcm_metadata.csv (the port of
octseg/data/extract_metadata.py).

The same 22 columns, date and time formats and CSV bytes as octseg's pandas
output (``core/table.py``); the port's DICOM parser (``data/dicom.py``);
broken files logged and kept as rows with their path and names only.
AcquisitionTime may be HHMMSS.ffffff, HHMMSS, HHMM or HH.

Paths in the config resolve against the working directory (octseg resolves
them against the repository root; the pipeline runs its stages from the
working directory it hashes).

Config: configs/extract_metadata.yaml. Usage:
python -m octseg_torch.data.extract_metadata [key=value ...]
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime

from octseg_torch.core.config import Config, entry_point
from octseg_torch.core.table import Table
from octseg_torch.data import dicom
from octseg_torch.data.utils import get_file_list, get_series_name, get_study_name

log = logging.getLogger(__name__)

COLUMNS = [
    'Path', 'Study UID', 'Series UID', 'Study name', 'Series name',
    'Acquisition Date', 'Acquisition Time', 'Patient Name', 'Patient Sex',
    'Body Part', 'Physician', 'Institution', 'Manufacturer', 'Modality',
    'Image Type', 'Height', 'Width', 'Slices', 'Channels', 'Data Type',
    'WC', 'WW',
]


def extract_metadata(dcm_path: str) -> dict:
    """One row of the metadata table for the DICOM at ``dcm_path``."""
    meta = {key: '' for key in COLUMNS}
    meta['Path'] = dcm_path
    meta['Study name'] = get_study_name(dcm_path)
    try:
        meta['Series name'] = get_series_name(dcm_path)
    except ValueError:
        pass
    try:
        ds = dicom.dcmread(dcm_path)
        meta['Study UID'] = str(ds.get('StudyInstanceUID', ''))
        meta['Series UID'] = str(ds.get('SeriesInstanceUID', ''))
        if 'AcquisitionDate' in ds:
            d = datetime.strptime(ds.AcquisitionDate, '%Y%m%d')
            meta['Acquisition Date'] = f'{d.day:02d}.{d.month:02d}.{d.year:d}'
        if 'AcquisitionTime' in ds:
            raw_t = str(ds.AcquisitionTime).strip()
            for fmt in ('%H%M%S.%f', '%H%M%S', '%H%M', '%H'):
                try:
                    t = datetime.strptime(raw_t, fmt)
                    break
                except ValueError:
                    continue
            else:
                raise ValueError(f'unparseable AcquisitionTime {raw_t!r}')
            meta['Acquisition Time'] = f'{t.hour:02d}:{t.minute:02d}:{t.second:02d}'
        for key, kw in [
            ('Patient Name', 'PatientName'), ('Patient Sex', 'PatientSex'),
            ('Body Part', 'BodyPartExamined'), ('Physician', 'PerformingPhysicianName'),
            ('Institution', 'InstitutionName'), ('Manufacturer', 'Manufacturer'),
            ('Modality', 'Modality'), ('Image Type', 'ImageType'),
        ]:
            if kw in ds:
                meta[key] = str(ds.get(kw))
        arr = ds.pixel_array
        meta['Slices'] = arr.shape[0]
        meta['Height'] = arr.shape[1]
        meta['Width'] = arr.shape[2]
        meta['Channels'] = arr.shape[3] if arr.ndim == 4 else 1
        meta['Data Type'] = str(arr.dtype)
        if 'WindowCenter' in ds:
            meta['WC'] = ds.WindowCenter
        if 'WindowWidth' in ds:
            meta['WW'] = ds.WindowWidth
        log.info('Processed DICOM: %s', dcm_path)
    except Exception:  # noqa: BLE001 - a broken file is logged and kept as a row
        log.warning('Broken DICOM: %s', dcm_path)
    return meta


@entry_point('extract_metadata')
def main(cfg: Config) -> None:
    data_dir, save_dir = os.path.abspath(cfg.data_dir), os.path.abspath(cfg.save_dir)
    dcm_list = get_file_list(src_dirs=data_dir, ext_list='', filename_template='IMG')
    with ThreadPoolExecutor(max(os.cpu_count() or 2, 2)) as pool:
        rows = list(pool.map(extract_metadata, dcm_list))
    os.makedirs(save_dir, exist_ok=True)
    Table.from_rows(COLUMNS, rows).to_csv(os.path.join(save_dir, 'dcm_metadata.csv'))
    log.info('Complete')


if __name__ == '__main__':
    main()
